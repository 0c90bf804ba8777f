from pfemfort_tpu_torch.sparse.dia import DIAMatrix, spmv_dia
from pfemfort_tpu_torch.sparse.formats import ELLMatrix
from pfemfort_tpu_torch.sparse.spmv import spmv_ell

__all__ = ["DIAMatrix", "spmv_dia", "ELLMatrix", "spmv_ell"]
