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
entry), never per inner iteration beyond CG's own flag.  RefineStats sums
the inner solves' loop_s, wait_s and host_reads (solve/cg.py) and adds its
own reads to the last.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from pfemfort_tpu_torch.solve.cg import cg_solve


@dataclasses.dataclass(frozen=True)
class RefineStats:
    outer_iters: int
    total_inner_iters: int
    relres: float          # final f64 relative residual
    converged: bool
    # the inner loops' host time and every blocking read; not compared
    loop_s: float = dataclasses.field(default=0.0, compare=False)
    wait_s: float = dataclasses.field(default=0.0, compare=False)
    host_reads: int = dataclasses.field(default=0, compare=False)

    def _replace(self, **changes) -> "RefineStats":
        """A copy with `changes` (the name it had as a NamedTuple)."""
        return dataclasses.replace(self, **changes)


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
        return torch.zeros_like(b64), RefineStats(0, 0, 0.0, True,
                                                  host_reads=1)

    def resid(x64):
        return b64 - op64(x64)

    if x0 is None:
        x64 = torch.zeros_like(b64)
        r64 = b64
    else:
        x64 = x0.to(torch.float64)
        r64 = resid(x64)
    total_inner, loop_s, wait_s, reads = 0, 0.0, 0.0, 1   # bnorm's read
    for outer in range(max_outer):
        relres = float(torch.linalg.vector_norm(r64)) / bnorm
        reads += 1
        if relres <= rtol:
            return x64, RefineStats(outer, total_inner, relres, True,
                                    loop_s, wait_s, reads)
        # scale the residual so the f32 inner solve sees O(1) magnitudes
        scale = float(r64.abs().max())
        scale = scale if scale > 0 else 1.0
        d32, st = cg_solve(op32, (r64 / scale).to(torch.float32),
                           precond=precond32, rtol=inner_rtol,
                           maxiter=inner_maxiter)
        total_inner += st.iters
        loop_s, wait_s = loop_s + st.loop_s, wait_s + st.wait_s
        reads += 1 + st.host_reads
        x64 = x64 + scale * d32.to(torch.float64)
        r64 = resid(x64)
    relres = float(torch.linalg.vector_norm(r64)) / bnorm
    return x64, RefineStats(max_outer, total_inner, relres, relres <= rtol,
                            loop_s, wait_s, reads + 1)
