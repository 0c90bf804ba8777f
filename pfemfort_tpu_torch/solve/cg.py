# Ported from pfemfort_tpu/solve/cg.py (CG, BiCGStab and the Jacobi preconditioner).
"""Preconditioned conjugate gradients and BiCGStab (torch).

Reimplements the reference's PETSc KSP layer (KSP=CG;
PFEMFort src/solverpetsc.F:187-209, KSPSolve at :476) as a host loop
over a user-supplied operator.  The vectors and the scalars of the
recurrence stay on the operator's device; the host reads one boolean per
iteration, the convergence test rr > tol2, so the iteration count is the
one the JAX package's `lax.while_loop` gives for the same numbers.

The inner product is injectable (`dot`, and for CG a fused pair `dot2`), as
in the JAX package: the distributed solves (parallel/shard_cg.py) pass a
local dot followed by an all_reduce, so every rank reads the same reduced
rr and takes the same branch.

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
    dot: Callable = torch.dot,
    dot2: Optional[Callable] = None,
):
    """Preconditioned conjugate gradients.

    Args:
      operator: x -> A x (SPD).
      b: right-hand side; its dtype is the working dtype of every vector,
        dot product and scalar of the recurrence.
      x0: initial guess (default zeros).
      precond: r -> M^{-1} r (default: identity).
      dot: inner product (a local dot + all_reduce for a distributed solve).
      dot2: optional fused pair (a, b, c, d) -> (a.b, c.d), so that a
        distributed caller reduces rz and rr after the preconditioner in ONE
        all_reduce; default two `dot` calls.
    Returns (x, SolveStats).
    """
    if dot2 is None:
        dot2 = lambda a, b_, c, d: (dot(a, b_), dot(c, d))
    if precond is None:
        precond = lambda r: r
    x = torch.zeros_like(b) if x0 is None else x0.clone()

    bnorm = torch.sqrt(dot(b, b))
    tol2 = torch.clamp_min(rtol * bnorm, atol) ** 2

    r = b - operator(x)
    z = precond(r)
    p = z.clone()
    rz = dot(r, z)
    rr = dot(r, r)

    k = 0
    while k < maxiter and bool(rr > tol2):
        Ap = operator(p)
        alpha = rz / dot(p, Ap)
        x.addcmul_(p, alpha)
        r.addcmul_(Ap, alpha, value=-1)
        z = precond(r)
        rz_new, rr = dot2(r, z, r, r)
        p.mul_(rz_new / rz).add_(z)
        rz = rz_new
        k += 1

    return x, _stats(k, rr, bnorm, tol2)


def _stats(k: int, rr: torch.Tensor, bnorm: torch.Tensor,
           tol2: torch.Tensor) -> SolveStats:
    relres = torch.sqrt(rr) / torch.where(bnorm > 0, bnorm, 1.0)
    return SolveStats(iters=k, relres=float(relres),
                      converged=bool(rr <= tol2))


def bicgstab_solve(
    operator: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    precond: Optional[Callable] = None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxiter: int = 10_000,
    dot: Callable = torch.dot,
):
    """Preconditioned BiCGStab (for the nonsymmetric systems the reference
    lets users request via the PETSc options file; solverpetsc.F:1-8).

    The same host loop as `cg_solve`: one boolean read per iteration, every
    vector and scalar on b's device; `dot` as in `cg_solve`.  Returns (x,
    SolveStats).
    """
    if precond is None:
        precond = lambda r: r
    x = torch.zeros_like(b) if x0 is None else x0.clone()

    bnorm = torch.sqrt(dot(b, b))
    tol2 = torch.clamp_min(rtol * bnorm, atol) ** 2

    r = b - operator(x)
    rhat = r.clone()
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    rr = dot(r, r)

    k = 0
    while k < maxiter and bool(rr > tol2):
        rho_new = dot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = precond(p)
        v = operator(phat)
        alpha = rho_new / dot(rhat, v)
        s = r - alpha * v
        shat = precond(s)
        t = operator(shat)
        omega = dot(t, s) / dot(t, t)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        rr = dot(r, r)
        k += 1
    return x, _stats(k, rr, bnorm, tol2)


def jacobi_preconditioner(diag: torch.Tensor) -> Callable:
    """PC=JACOBI: z = r / diag(A), with zero diagonal entries left as 1."""
    inv = torch.where(diag != 0, 1.0 / diag, 1.0)
    return lambda r: r * inv
