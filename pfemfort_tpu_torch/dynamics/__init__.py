from pfemfort_tpu_torch.dynamics.explicit import explicit_dynamics, \
    ExplicitResult

__all__ = ["explicit_dynamics", "ExplicitResult"]
