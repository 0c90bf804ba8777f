from pfemfort_tpu_torch.drivers.poisson import solve_poisson
from pfemfort_tpu_torch.drivers.elasticity import solve_elasticity

__all__ = ["solve_poisson", "solve_elasticity"]
