from pfemfort_tpu_torch.solve.cg import bicgstab_solve, cg_solve, SolveStats
from pfemfort_tpu_torch.solve.gmres import gmres_solve

__all__ = ["cg_solve", "bicgstab_solve", "gmres_solve", "SolveStats"]
