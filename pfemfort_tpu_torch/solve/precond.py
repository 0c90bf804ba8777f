# Ported from pfemfort_tpu/solve/precond.py.
"""Preconditioners beyond scalar Jacobi.

The reference's PETSc defaults are block-Jacobi with one ILU block per MPI
rank (PFEMFort src/solverpetsc.F:206) and plain ILU for the serial drivers
(triapoissonserialimpl1.F:696).  Substitutes without triangular solves:

  * point-block Jacobi — nodal (ndof x ndof) blocks with closed-form
    inverses (captures elasticity's inter-component coupling);
  * CHEBYSHEV polynomial preconditioning — z = p_k(D^{-1}A) D^{-1} r, a
    fixed-degree polynomial of the Jacobi-scaled operator: k - 1 extra
    SpMVs per application through the solve's own operator (kernel B1 or
    B2 on the card), SPD-preserving.

Every scalar (lmax and the recurrence's coefficients) stays a tensor on the
operator's device: set-up and application read nothing back to the host.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

from pfemfort_tpu_torch.sparse.dia import DIAMatrix
from pfemfort_tpu_torch.sparse.formats import ELLMatrix


def _block_diag_from_dia(A: DIAMatrix, bs: int) -> torch.Tensor:
    """Nodal blocks (bs, bs, N/bs) of a DIA matrix.

    Entry (r, r+o) belongs to a diagonal block iff r//bs == (r+o)//bs; with
    r = rm + k*bs that is 0 <= rm + o < bs, a static condition per (o, rm),
    so extraction is strided slicing."""
    n = A.n_rows
    nb = n // bs
    if nb * bs != n:
        raise ValueError(f"n_rows {n} is not a multiple of block size {bs}")
    blocks = A.vals.new_zeros((bs, bs, nb))
    for d, o in enumerate(A.offsets):
        if abs(o) >= bs:
            continue
        for rm in range(bs):
            cm = rm + o
            if 0 <= cm < bs:
                blocks[rm, cm] += A.vals[d, rm::bs]
    return blocks


def _inv_blocks(Bk: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (bs, bs, nb) blocks for bs in {1, 2, 3}."""
    bs = Bk.shape[0]
    if bs == 1:
        return torch.where(Bk != 0, 1.0 / Bk, 1.0)
    if bs == 2:
        a, b = Bk[0, 0], Bk[0, 1]
        c, d = Bk[1, 0], Bk[1, 1]
        det = a * d - b * c
        det = torch.where(det != 0, det, 1.0)
        return torch.stack([
            torch.stack([d, -b]), torch.stack([-c, a])]) / det
    if bs == 3:
        a, b, c = Bk[0, 0], Bk[0, 1], Bk[0, 2]
        d, e, f = Bk[1, 0], Bk[1, 1], Bk[1, 2]
        g, h, i = Bk[2, 0], Bk[2, 1], Bk[2, 2]
        A_ = e * i - f * h
        B_ = -(d * i - f * g)
        C_ = d * h - e * g
        det = a * A_ + b * B_ + c * C_
        det = torch.where(det != 0, det, 1.0)
        return torch.stack([
            torch.stack([A_, -(b * i - c * h), (b * f - c * e)]),
            torch.stack([B_, (a * i - c * g), -(a * f - c * d)]),
            torch.stack([C_, -(a * h - b * g), (a * e - b * d)]),
        ]) / det
    raise ValueError(f"block size {bs} not supported (use 1, 2 or 3)")


def block_jacobi_preconditioner(A: Union[DIAMatrix, ELLMatrix],
                                block_size: int) -> Callable:
    """z = blockdiag(A)^{-1} r with nodal (ndof x ndof) blocks.

    Requires n_rows divisible by block_size (reduced systems of vector
    problems with per-node BC elimination may break nodal alignment)."""
    bs = block_size
    if isinstance(A, ELLMatrix):
        # entry (r, c) is in-block iff both lie on the same node
        n = A.n_rows
        nb = n // bs
        if nb * bs != n:
            raise ValueError(f"n_rows {n} is not a multiple of block size "
                             f"{bs}")
        cols = A.cols.long()
        rows = torch.arange(n, device=cols.device)[:, None]
        inblk = ((cols // bs) == (rows // bs)) & (cols < A.n_cols)
        cmod = torch.where(inblk, cols % bs, bs)        # bs = dropped
        contrib = torch.where(inblk, A.vals, 0.0)
        blocks = A.vals.new_zeros((bs, bs, nb))
        for rm in range(bs):
            for cm in range(bs):
                mask = cmod[rm::bs] == cm
                blocks[rm, cm] = torch.where(mask, contrib[rm::bs],
                                             0.0).sum(dim=1)
    else:
        blocks = _block_diag_from_dia(A, bs)
    inv = _inv_blocks(blocks)

    def apply(r):
        rb = r.reshape(-1, bs).T                      # (bs, nb)
        zb = sum(inv[:, d, :] * rb[d][None, :] for d in range(bs))
        return zb.T.reshape(-1)

    return apply


def estimate_lmax_jacobi(operator: Callable, diag: torch.Tensor,
                         iters: int = 12) -> torch.Tensor:
    """Largest eigenvalue of D^{-1}A by `iters` steps of power iteration from
    the deterministic start vector sin(1, 2, ..., n); a 0-d tensor."""
    dinv = torch.where(diag != 0, 1.0 / diag, 1.0)
    n = diag.shape[0]
    v = torch.sin(torch.arange(n, dtype=diag.dtype, device=diag.device) + 1.0)
    v = v / torch.linalg.vector_norm(v)
    lam = torch.ones((), dtype=diag.dtype, device=diag.device)
    for _ in range(iters):
        w = dinv * operator(v)
        lam = torch.linalg.vector_norm(w)
        v = w / torch.where(lam > 0, lam, 1.0)
    return lam


def chebyshev_preconditioner(operator: Callable, diag: torch.Tensor,
                             lmax=None, lmin=None,
                             degree: int = 3) -> Callable:
    """z = p_k(D^{-1}A) D^{-1} r: Chebyshev polynomial of the Jacobi-scaled
    operator over [lmin, lmax].

    A fixed linear SPD operator (safe inside CG); degree - 1 SpMVs per
    application.  Default bounds: lmax from power iteration * 1.05,
    lmin = lmax / 30 (the smoother convention: clustering the high end is
    what helps CG)."""
    dinv = torch.where(diag != 0, 1.0 / diag, 1.0)
    if lmax is None:
        lmax = estimate_lmax_jacobi(operator, diag) * 1.05
    if lmin is None:
        lmin = lmax / 30.0
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    # the recurrence's coefficients depend on lmax alone: computed once
    rhos = [1.0 / sigma1]
    for _ in range(1, degree):
        rhos.append(1.0 / (2.0 * sigma1 - rhos[-1]))
    coefs = [(rhos[k] * rhos[k - 1], 2.0 * rhos[k] / delta)
             for k in range(1, degree)]

    def apply(r):
        rd = dinv * r
        z = rd / theta
        d = z
        for c_d, c_r in coefs:
            resid = rd - dinv * operator(z)
            d = c_d * d + c_r * resid
            z = z + d
        return z

    return apply
