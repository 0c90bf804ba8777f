from pfemfort_tpu_torch.solve.cg import cg_solve, SolveStats

__all__ = ["cg_solve", "SolveStats"]
