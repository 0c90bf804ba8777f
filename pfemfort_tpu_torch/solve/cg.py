# Ported from pfemfort_tpu/solve/cg.py (CG and the Jacobi preconditioner).
"""Preconditioned conjugate gradients (torch).

Reimplements the reference's PETSc KSP layer (KSP=CG;
/root/reference/src/solverpetsc.F:187-209, KSPSolve at :476) as a host loop
over a user-supplied operator.  The vectors and the scalars of the
recurrence stay on the operator's device; the host reads one boolean per
iteration, the convergence test rr > tol2, so the iteration count is the
one the JAX package's `lax.while_loop` gives for the same numbers.

Convergence: relative residual ||r|| / ||b|| <= rtol (or ||r|| <= atol).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class SolveStats(NamedTuple):
    iters: int        # iterations performed
    relres: float     # final relative residual
    converged: bool


def cg_solve(
    operator: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    precond: Optional[Callable] = None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxiter: int = 10_000,
):
    """Preconditioned conjugate gradients.

    Args:
      operator: x -> A x (SPD).
      b: right-hand side; its dtype is the working dtype of every vector,
        dot product and scalar of the recurrence.
      x0: initial guess (default zeros).
      precond: r -> M^{-1} r (default: identity).
    Returns (x, SolveStats).
    """
    if precond is None:
        precond = lambda r: r
    x = torch.zeros_like(b) if x0 is None else x0.clone()

    bnorm = torch.sqrt(torch.dot(b, b))
    tol2 = torch.clamp_min(rtol * bnorm, atol) ** 2

    r = b - operator(x)
    z = precond(r)
    p = z.clone()
    rz = torch.dot(r, z)
    rr = torch.dot(r, r)

    k = 0
    while k < maxiter and bool(rr > tol2):
        Ap = operator(p)
        alpha = rz / torch.dot(p, Ap)
        x.addcmul_(p, alpha)
        r.addcmul_(Ap, alpha, value=-1)
        z = precond(r)
        rz_new = torch.dot(r, z)
        rr = torch.dot(r, r)
        p.mul_(rz_new / rz).add_(z)
        rz = rz_new
        k += 1

    relres = torch.sqrt(rr) / torch.where(bnorm > 0, bnorm, 1.0)
    return x, SolveStats(iters=k, relres=float(relres),
                         converged=bool(rr <= tol2))


def jacobi_preconditioner(diag: torch.Tensor) -> Callable:
    """PC=JACOBI: z = r / diag(A), with zero diagonal entries left as 1."""
    inv = torch.where(diag != 0, 1.0 / diag, 1.0)
    return lambda r: r * inv
