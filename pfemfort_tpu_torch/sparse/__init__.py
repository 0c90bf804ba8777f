from pfemfort_tpu_torch.sparse.dia import DIAMatrix, spmv_dia
from pfemfort_tpu_torch.sparse.formats import ELLMatrix
from pfemfort_tpu_torch.sparse.sliced import SlicedELL, slice_ell
from pfemfort_tpu_torch.sparse.spmv import spmv_ell, spmv_sliced

__all__ = ["DIAMatrix", "spmv_dia", "ELLMatrix", "spmv_ell", "SlicedELL",
           "slice_ell", "spmv_sliced"]
