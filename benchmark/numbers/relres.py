"""Number `relres`: implicit analyses, the reduced system's true relative
residual with the Dirichlet values held too.  The largest over a sample of
the window's analyses (harness/check.py:analysis_sample) of

  max(|F - K u| over the free rows / |F - K u_D| over the free rows,
      |u - g| over the Dirichlet dofs / |u|),

K, F and g worked out again in float64 by the plain reference.

Control: the plain reference's Jacobi-CG (reference/fem.py:cg) in the
program's place, computed in bfloat16, the precision below the float32 the
configuration states (the port has no bfloat16 path).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import check
from benchmark.reference import fem

CONTROL = "bfloat16 (the plain reference's Jacobi-CG)"
CAP = 1000     # iterations of a control solve


def analysis_value(traffic, p: fem.Problem, unit: dict, full: bool) -> float:
    """One analysis's residual: the reduced one, or (full) the full system's
    with identity Dirichlet rows,
    sqrt(|F - K u|_free^2 + |g - u_D|^2) / sqrt(|F|_free^2 + |g|^2)."""
    load, phys = unit["load"], traffic.physics
    bc, g = phys.dirichlet_dofs(traffic, load, p)
    F = phys.load_vector(traffic, load, p)
    u = torch.as_tensor(np.asarray(unit["answer"]), dtype=p.geom.vol.dtype,
                        device=p.conn.device)
    n = fem.residual_norms(p, F, u, bc, g)
    if full:
        return float(np.hypot(n["r_free"], n["bc_misfit"])
                     / np.hypot(n["f_free"], n["g"]))
    return max(n["r_free"] / n["b_reduced"],
               n["bc_misfit"] / max(n["u"], 1e-300))


def sampled(traffic, units: list, full: bool) -> float:
    p = check.reference_problem(traffic)
    value = max(analysis_value(traffic, p, units[i], full)
                for i in check.analysis_sample(traffic, len(units)))
    del p
    return value


def value(traffic, units: list) -> float:
    return sampled(traffic, units, full=False)


def control(traffic, n_units: int, dtype=torch.bfloat16,
            maxiter: int = CAP) -> list:
    """n_units analyses of the cell's loads by the plain reference's
    Jacobi-CG in `dtype` (float32 with a larger maxiter is the witness of
    the float32 floor)."""
    p = check.reference_problem(traffic, dtype=dtype)
    units = []
    for _ in range(n_units):
        load = traffic.next_load()
        bc, g = traffic.physics.dirichlet_dofs(traffic, load, p)
        F = traffic.physics.load_vector(traffic, load, p)
        u, iters = fem.cg(p, F, bc, g, traffic.mix["rtol"], maxiter)
        units.append(dict(answer=u.double().cpu().numpy(), load=load,
                          iters=iters, converged=True))
    return units
