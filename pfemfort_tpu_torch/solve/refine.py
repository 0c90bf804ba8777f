# Ported from pfemfort_tpu/solve/refine.py (cg_with_refinement).
"""Mixed-precision iterative refinement: f32 CG inner, f64 residual outer.

The reference runs fully in double precision and targets 1e-8 relative
residuals (solverpetsc.F / PETSc defaults).  Here:
  * inner solves in f32 (half the bytes of every SpMV and vector pass),
  * outer residual r = b - A x in f64, native on the card (the JAX package's
    double-float emulation, solve/doublefloat.py, existed because a TPU has
    no f64 and is not carried over),
  * the solution accumulated in f64.
Classical iterative refinement converges to f64-level residuals as long as
CG contracts the error by more than the f32 rounding floor each cycle.  The
host reads two scalars per outer cycle (the residual's norm and its largest
entry), never per inner iteration beyond CG's own flag.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from pfemfort_tpu_torch.solve.cg import cg_solve


class RefineStats(NamedTuple):
    outer_iters: int
    total_inner_iters: int
    relres: float          # final f64 relative residual
    converged: bool


def cg_with_refinement(
    op64: Callable,       # x (f64) -> A x in f64
    op32: Callable,       # x (f32) -> A x in f32
    b64: torch.Tensor,
    precond32: Optional[Callable] = None,
    rtol: float = 1e-8,
    inner_rtol: float = 1e-5,
    max_outer: int = 20,
    inner_maxiter: int = 10_000,
    x0: Optional[torch.Tensor] = None,
):
    """Solve A x = b to f64 relative residual `rtol` with f32 inner CG.

    `x0`: optional f64 initial guess (the full-system BC-carrying start);
    inner corrections then live on the zero-BC subspace.
    Returns (x (f64, on b's device), RefineStats)."""
    b64 = b64.to(torch.float64)
    bnorm = float(torch.linalg.vector_norm(b64))
    if bnorm == 0.0:
        return torch.zeros_like(b64), RefineStats(0, 0, 0.0, True)

    def resid(x64):
        return b64 - op64(x64)

    if x0 is None:
        x64 = torch.zeros_like(b64)
        r64 = b64
    else:
        x64 = x0.to(torch.float64)
        r64 = resid(x64)
    total_inner = 0
    for outer in range(max_outer):
        relres = float(torch.linalg.vector_norm(r64)) / bnorm
        if relres <= rtol:
            return x64, RefineStats(outer, total_inner, relres, True)
        # scale the residual so the f32 inner solve sees O(1) magnitudes
        scale = float(r64.abs().max())
        scale = scale if scale > 0 else 1.0
        d32, st = cg_solve(op32, (r64 / scale).to(torch.float32),
                           precond=precond32, rtol=inner_rtol,
                           maxiter=inner_maxiter)
        total_inner += st.iters
        x64 = x64 + scale * d32.to(torch.float64)
        r64 = resid(x64)
    relres = float(torch.linalg.vector_norm(r64)) / bnorm
    return x64, RefineStats(max_outer, total_inner, relres, relres <= rtol)
