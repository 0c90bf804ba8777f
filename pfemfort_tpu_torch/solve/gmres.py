# Ported from pfemfort_tpu/solve/gmres.py.
"""Restarted GMRES(m) (torch).

Completes the Krylov menu the reference exposes through its PETSc options
file (CG <-> BiCGStab <-> GMRES switchable without recompiling;
PFEMFort src/solverpetsc.F:1-8, 198).  Arnoldi with modified
Gram-Schmidt and Givens rotations, as a host loop like solve/cg.py's: the
Krylov basis, the Hessenberg matrix, the rotations and every scalar stay on
b's device, and the host reads one boolean per Arnoldi step (is the
residual estimate still above the tolerance?) and one per restart.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from pfemfort_tpu_torch.solve.cg import SolveStats


def gmres_solve(
    operator: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    precond: Optional[Callable] = None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    restart: int = 30,
    maxiter: int = 1000,
    dot: Callable = torch.dot,
):
    """Left-preconditioned restarted GMRES.  Returns (x, SolveStats).

    Convergence is tested on the PRECONDITIONED residual ||M^{-1}(b-Ax)||
    (the Givens-recurrence estimate |g_j|, free per step) relative to
    ||M^{-1}b|| — PETSc's default left-preconditioned convention
    (KSP_NORM_PRECONDITIONED), unlike cg_solve's true-residual test.
    Arnoldi stops MID-CYCLE as soon as |g_j| <= tol, so a converged solve
    does not pay for the rest of its restart window.  `iters` counts
    Arnoldi steps over all cycles.  `dot` is the inner product of the
    n-vectors (a local dot + all_reduce for a distributed solve); the
    back-substitution's products of m-vectors stay local.
    """
    if precond is None:
        precond = lambda r: r
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    m = restart
    n = b.shape[0]
    new = lambda *shape: b.new_zeros(shape)

    Mb = precond(b)
    bnorm = torch.sqrt(dot(Mb, Mb))
    tol = torch.clamp_min(rtol * bnorm, atol)

    def arnoldi_cycle(x):
        r = precond(b - operator(x))
        beta = torch.sqrt(dot(r, r))
        V = new(m + 1, n)
        H = new(m + 1, m)
        cs, sn, g = new(m), new(m), new(m + 1)
        g[0] = beta
        V[0] = r / torch.where(beta > 0, beta, 1.0)

        j = 0
        while j < m and bool(torch.abs(g[j]) > tol):
            w = precond(operator(V[j]))
            hcol = new(m + 1)
            # modified Gram-Schmidt against rows 0..j (rows > j are zero)
            for i in range(j + 1):
                hij = dot(w, V[i])
                w = w - hij * V[i]
                hcol[i] = hij
            hjp1 = torch.sqrt(dot(w, w))
            hcol[j + 1] = hjp1
            V[j + 1] = w / torch.where(hjp1 > 0, hjp1, 1.0)
            # apply the previous Givens rotations to the new column
            for i in range(j):
                hi = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                hip = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                hcol[i] = hi
                hcol[i + 1] = hip
            # a new rotation annihilates hcol[j+1]
            denom = torch.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            c = torch.where(denom > 0, hcol[j] / denom, 1.0)
            s = torch.where(denom > 0, hcol[j + 1] / denom, 0.0)
            hcol[j] = denom
            hcol[j + 1] = 0.0
            cs[j] = c
            sn[j] = s
            gj = g[j].clone()
            g[j + 1] = -s * gj
            g[j] = c * gj
            H[:, j] = hcol
            j += 1

        # back-substitute H y = g (upper triangular m x m); unfilled columns
        # have H[j,j] == 0 -> y[j] == 0, so the full-m sweep is exact for a
        # partial cycle too
        y = new(m)
        for jj in range(m - 1, -1, -1):
            sj = g[jj] - torch.dot(H[jj], y)
            y[jj] = torch.where(H[jj, jj] != 0, sj / H[jj, jj], 0.0)
        x = x + y @ V[:m]
        return x, torch.abs(g[j]), j

    r0 = precond(b - operator(x))
    res = torch.sqrt(dot(r0, r0))
    iters = 0
    while bool(res > tol) and iters < maxiter:
        x, res, jdone = arnoldi_cycle(x)
        iters += jdone
    relres = res / torch.where(bnorm > 0, bnorm, 1.0)
    return x, SolveStats(iters=iters, relres=float(relres),
                         converged=bool(res <= tol))
