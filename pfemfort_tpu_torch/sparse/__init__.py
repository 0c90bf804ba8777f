from pfemfort_tpu_torch.sparse.dia import DIAMatrix, spmv_dia

__all__ = ["DIAMatrix", "spmv_dia"]
