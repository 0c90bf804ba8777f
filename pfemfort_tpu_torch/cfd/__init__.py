from pfemfort_tpu_torch.cfd.navierstokes import fractional_step_ns, NSResult

__all__ = ["fractional_step_ns", "NSResult"]
