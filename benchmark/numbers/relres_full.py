"""Number `relres_full`: float64 analyses, the full system's true relative
residual with identity Dirichlet rows, as the configuration states its
tolerance:

  sqrt(|F - K u|_free^2 + |g - u_D|^2) / sqrt(|F|_free^2 + |g|^2),

the largest over a sample of the window's analyses, K, F and g worked out
again in float64 by the plain reference.

Control: the port's own float32 path of the same problem, the precision
below the float64 the configuration states: the physics' implicit driver
with dtype=float32, bc_mode='full', precond='mg' and the mix's rtol, capped
at CAP iterations.
"""

from __future__ import annotations

import torch

from benchmark.harness import registry

CONTROL = "float32 (the port's own path)"
CAP = 1000


def value(traffic, units: list) -> float:
    return registry.module("numbers", "relres").sampled(traffic, units,
                                                        full=True)


def control(traffic, n_units: int, dtype=torch.float32,
            maxiter: int = CAP) -> list:
    units = []
    for _ in range(n_units):
        load = traffic.next_load()
        res = traffic.physics.solve(traffic, load, dtype=dtype,
                                    rtol=traffic.mix["rtol"],
                                    bc_mode="full", precond="mg",
                                    maxiter=maxiter)
        units.append(dict(answer=res.u_full, load=load,
                          iters=int(res.stats.iters),
                          converged=bool(res.stats.converged)))
    return units
