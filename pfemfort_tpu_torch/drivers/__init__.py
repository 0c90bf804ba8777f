from pfemfort_tpu_torch.drivers.poisson import solve_poisson

__all__ = ["solve_poisson"]
