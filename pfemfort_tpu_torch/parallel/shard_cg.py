# Ported from pfemfort_tpu/parallel/shard_cg.py (the DIA halo route, the all-gather ELL route and the ghost-exchange ELL route).
"""Distributed Krylov solves over the default process group.

The reference's multi-rank solve is PETSc KSP over MPI: SpMV with a halo
exchange plus dot-product allreduces (PFEMFort src/solverpetsc.F:476,
SURVEY §2.6).  Every rank calls these functions with its own block of rows
and runs the same Krylov body (solve/cg.py, solve/gmres.py) with
  * its in-shard SpMV: the halo-exchange DIA product (parallel/halo.py;
    kernel B1's halo entry on the card), the ghost-exchange ELL product
    (parallel/dist_ell.py; kernel B2 on the ghost-extended block, or the
    per-rank hybrid: B1 on the rank's dense local diagonals and B2 on the
    remainder) or, on the all-gather route, the gathered x times the
    rank's rows (kernel B2 on the card);
  * dots = a local torch.dot followed by one all_reduce (PETSc's VecDot
    allreduce); `dot2` stacks CG's two dots after the preconditioner into
    ONE all_reduce.  Every rank reads the same reduced scalars, so every
    rank takes the same branch;
  * the solution all_gathered, so every rank returns the whole x (the
    reference's VecScatterCreateToAll, triapoissonparallelimpl1.F:938-943).
A card tensor always takes the kernels, at every size and in both dtypes.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from pfemfort_tpu_torch.parallel.dist_ell import EllHalo, spmv_ell_halo, \
    spmv_ell_halo_hybrid
from pfemfort_tpu_torch.parallel.halo import halo_width, spmv_dia_halo, \
    spmv_dia_halo_b1
from pfemfort_tpu_torch.solve.cg import SolveStats, bicgstab_solve, \
    cg_solve, jacobi_preconditioner
from pfemfort_tpu_torch.solve.gmres import gmres_solve
from pfemfort_tpu_torch.solve.ic0 import IC0Arrays, ic0_preconditioner
from pfemfort_tpu_torch.sparse.dia import DIAMatrix
from pfemfort_tpu_torch.sparse.ell_spmv_cuda import ell_spmv
from pfemfort_tpu_torch.sparse.hybrid import HybridMatrix
from pfemfort_tpu_torch.sparse.sliced import slice_ell


def _krylov_body(method: str) -> Callable:
    """Uniform (operator, b_l, precond, rtol, maxiter, dot, dot2) -> (x_l,
    stats) over the Krylov menu, the distributed form of the reference's
    options-file -ksp_type switch (PFEMFort src/solverpetsc.F:198)."""
    if method == "cg":
        return lambda op, b, pc, rtol, maxiter, dot, dot2: cg_solve(
            op, b, precond=pc, rtol=rtol, maxiter=maxiter,
            dot=dot, dot2=dot2)
    if method == "bicgstab":
        return lambda op, b, pc, rtol, maxiter, dot, dot2: bicgstab_solve(
            op, b, precond=pc, rtol=rtol, maxiter=maxiter, dot=dot)
    if method == "gmres":
        return lambda op, b, pc, rtol, maxiter, dot, dot2: gmres_solve(
            op, b, precond=pc, rtol=rtol, maxiter=maxiter, dot=dot)
    raise ValueError(f"unknown ksp method {method!r}")


def _reduced_dots() -> Tuple[Callable, Callable]:
    """(dot, dot2): local dots summed over every rank by one all_reduce
    each."""
    def dot(a, c):
        s = torch.dot(a, c).reshape(1)
        dist.all_reduce(s)
        return s[0]

    def dot2(a, c, d, e):
        pair = torch.stack([torch.dot(a, c), torch.dot(d, e)])
        dist.all_reduce(pair)
        return pair[0], pair[1]

    return dot, dot2


def _gathered(x_l: torch.Tensor) -> torch.Tensor:
    """The rank-ordered concatenation of every rank's x_l, on every rank."""
    parts = [torch.empty_like(x_l) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x_l.contiguous())
    return torch.cat(parts)


def _inv_small_blocks(B: torch.Tensor) -> torch.Tensor:
    """Closed-form batched inverse of (m, nd, nd) SPD blocks, nd in {1,2,3}.

    Zero-diagonal rows (padding equations) are replaced by identity
    rows/columns first so the block stays invertible and decoupled."""
    nd = B.shape[-1]
    B = B.clone()
    eye = torch.eye(nd, dtype=B.dtype, device=B.device)
    for a in range(nd):
        zero = (B[:, a, a] == 0)[:, None]
        B[:, a, :] = torch.where(zero, eye[a], B[:, a, :])
        B[:, :, a] = torch.where(zero, eye[a], B[:, :, a])
    if nd == 1:
        return 1.0 / B
    if nd == 2:
        a, b = B[:, 0, 0], B[:, 0, 1]
        c, d = B[:, 1, 0], B[:, 1, 1]
        det = a * d - b * c
        inv = torch.stack([torch.stack([d, -b], -1),
                           torch.stack([-c, a], -1)], -2)
        return inv / det[:, None, None]
    if nd == 3:
        a, b, c = B[:, 0, 0], B[:, 0, 1], B[:, 0, 2]
        d, e, f = B[:, 1, 0], B[:, 1, 1], B[:, 1, 2]
        g, h, i = B[:, 2, 0], B[:, 2, 1], B[:, 2, 2]
        A_ = e * i - f * h
        B_ = -(d * i - f * g)
        C_ = d * h - e * g
        det = a * A_ + b * B_ + c * C_
        inv = torch.stack([
            torch.stack([A_, -(b * i - c * h), b * f - c * e], -1),
            torch.stack([B_, a * i - c * g, -(a * f - c * d)], -1),
            torch.stack([C_, -(a * h - b * g), a * e - b * d], -1),
        ], -2)
        return inv / det[:, None, None]
    return torch.linalg.inv(B)


def block_jacobi_dia_preconditioner(offsets, vals_l: torch.Tensor,
                                    nd: int) -> Callable:
    """PC=BJACOBI with per-node (nd x nd) blocks, extracted from the rank's
    DIA rows: the reference's default preconditioner (solverpetsc.F:206)
    at node-block granularity.  Rows k*nd+a couple to cols k*nd+b through
    diagonal offset b - a."""
    P_ = vals_l.shape[1]
    m = P_ // nd
    oidx = {o: d for d, o in enumerate(offsets)}
    cols = []
    for a in range(nd):
        row = []
        for b in range(nd):
            o = b - a
            if o in oidx:
                row.append(vals_l[oidx[o]].reshape(m, nd)[:, a])
            else:
                row.append(vals_l.new_zeros(m))
        cols.append(torch.stack(row, -1))
    Binv = _inv_small_blocks(torch.stack(cols, -2))      # (m, nd, nd)

    def apply(r):
        return torch.einsum("kab,kb->ka", Binv, r.reshape(m, nd)).reshape(-1)
    return apply


def block_jacobi_ell_preconditioner(cols_local: torch.Tensor,
                                    vals_l: torch.Tensor,
                                    nd: int) -> Callable:
    """PC=BJACOBI with per-node (nd x nd) blocks from the rank's LOCAL ELL
    block: the reference's default preconditioner (solverpetsc.F:206) on
    the unstructured distributed route.  Needs the node-aligned row layout
    (parallel/shard.py: each node owns nd consecutive local rows), so entry
    (r, c) is in its block iff c is an OWN column (< P) of the same
    nd-aligned group; padding rows invert to identity."""
    P_, K = vals_l.shape
    m = P_ // nd
    c = cols_local.long()
    rows = torch.arange(P_, dtype=torch.int64, device=c.device)[:, None]
    inblk = (c < P_) & (torch.div(c, nd, rounding_mode="floor")
                        == torch.div(rows, nd, rounding_mode="floor"))
    contrib = torch.where(inblk, vals_l, 0.0)
    cmod = torch.where(inblk, c % nd, nd)             # nd = dropped
    cols = []
    for a in range(nd):
        c_a, v_a = cmod[a::nd], contrib[a::nd]        # (m, K)
        cols.append(torch.stack([torch.where(c_a == b, v_a, 0.0).sum(1)
                                 for b in range(nd)], -1))
    Binv = _inv_small_blocks(torch.stack(cols, -2))   # (m, nd, nd)

    def apply(r):
        return torch.einsum("kab,kb->ka", Binv, r.reshape(m, nd)).reshape(-1)
    return apply


def distributed_cg_solve(
    cols_l: torch.Tensor,     # (P, K) int32 GLOBAL column ids, sentinel N
    vals_l: torch.Tensor,     # (P, K)
    b_l: torch.Tensor,        # (P,)
    rtol: float = 1e-8,
    maxiter: int = 10_000,
    method: str = "cg",
):
    """Jacobi-preconditioned Krylov solve, all-gather route: each iteration
    gathers x, then multiplies the rank's rows by their global columns
    (kernel B2 on the card, in the sliced layout with n_cols = N, so the
    sentinel column N is dropped; spmv_sliced on the CPU).

    Returns (x (N,) on every rank, SolveStats)."""
    P_ = cols_l.shape[0]
    N = dist.get_world_size() * P_
    row0 = dist.get_rank() * P_
    krylov = _krylov_body(method)
    A_l = slice_ell(cols_l, N).pack(vals_l)
    rows = torch.arange(P_, dtype=torch.int64,
                        device=cols_l.device)[:, None] + row0
    diag = torch.where(cols_l.long() == rows, vals_l, 0).sum(1)

    def operator(x_l):
        return ell_spmv(A_l, _gathered(x_l))

    dot, dot2 = _reduced_dots()
    x_l, stats = krylov(operator, b_l, jacobi_preconditioner(diag), rtol,
                        maxiter, dot, dot2)
    return _gathered(x_l), stats


def distributed_cg_solve_ell(
    cols_local: torch.Tensor,   # (P, K) int32 ghost-extended column ids
    vals_l: torch.Tensor,       # (P, K) this rank's rows
    b_l: torch.Tensor,          # (P,)
    halo: EllHalo,
    rtol: float = 1e-8,
    maxiter: int = 10_000,
    ndof_block: int = 1,
    ic0: Optional[IC0Arrays] = None,
    method: str = "cg",
    amg=None,
    hybrid: Optional[HybridMatrix] = None,
) -> Tuple[torch.Tensor, SolveStats]:
    """Krylov solve over the unstructured per-rank ELL blocks with the
    pairwise ghost exchange (parallel/dist_ell.py:spmv_ell_halo): per
    iteration the partition surface's values plus the dot all_reduces, not
    the whole vector.

    The operator: with `hybrid`, the rank's hybrid of the same values
    (dist_ell.build_ell_halo_hybrid, laid out and packed by
    sparse/hybrid.py:hybrid_layout), multiplied by
    dist_ell.spmv_ell_halo_hybrid: B1 on its dense local diagonals, B2 on
    its remainder and ghost columns; else the rank's block laid out once
    in the sliced layout of its ghost-extended column space, every product
    on a card tensor kernel B2 (spmv_sliced on a CPU tensor).  The
    preconditioners below read `cols_local` and `vals_l` either way.  The
    preconditioner: `ic0`, the
    rank's IC(0) block (solve/ic0.py:build_ic0_shard_block; PC=BJACOBI
    with one ILU-class factorization per rank, its T and T^T products on
    B2 too), under every Krylov method; else per-node block-Jacobi for
    ndof_block > 1 with P % ndof_block == 0; else Jacobi from the local
    diagonal.  `amg`, the rank's share of a distributed SA-AMG hierarchy
    (solve/amg.py:build_dist_samg), takes precedence over `ic0` and
    `ndof_block`, as in the JAX package; its fine smoother is this solve's
    own operator (the hybrid when given).

    Returns (x (N,) on every rank, SolveStats)."""
    P_ = b_l.shape[0]
    krylov = _krylov_body(method)
    if hybrid is not None:
        def operator(x_l):
            return spmv_ell_halo_hybrid(hybrid, halo, x_l)
    else:
        A_l = slice_ell(cols_local, halo.n_cols).pack(vals_l)

        def operator(x_l):
            return spmv_ell_halo(A_l, halo, x_l)

    rows = torch.arange(P_, dtype=torch.int64, device=b_l.device)[:, None]
    if amg is not None:
        from pfemfort_tpu_torch.solve.amg import dist_samg_preconditioner

        d = torch.where(cols_local.long() == rows, vals_l, 0).sum(1)
        precond = dist_samg_preconditioner(
            amg, torch.where(d != 0, 1.0 / d, 0.0), operator)
    elif ic0 is not None:
        precond = ic0_preconditioner(ic0)
    elif ndof_block > 1 and P_ % ndof_block == 0:
        precond = block_jacobi_ell_preconditioner(cols_local, vals_l,
                                                  ndof_block)
    else:
        precond = jacobi_preconditioner(
            torch.where(cols_local.long() == rows, vals_l, 0).sum(1))
    dot, dot2 = _reduced_dots()
    x_l, stats = krylov(operator, b_l, precond, rtol, maxiter, dot, dot2)
    return _gathered(x_l), stats


def distributed_cg_solve_dia(
    offsets,                  # tuple of diagonal offsets
    vals_l: torch.Tensor,     # (D, P) this rank's rows
    b_l: torch.Tensor,        # (P,)
    rtol: float = 1e-8,
    maxiter: int = 10_000,
    ndof_block: int = 1,
    method: str = "cg",
) -> Tuple[torch.Tensor, SolveStats]:
    """Krylov solve with the halo-exchange DIA SpMV: per iteration two
    point-to-point shifts of w = halo_width(offsets) values plus the dot
    all_reduces, the 'interior SpMV + neighbour halo' structure PETSc uses
    over MPI (SURVEY §5).

    On a card tensor the in-shard product is kernel B1's halo entry; on a
    CPU tensor it is its plain form, parallel/halo.py:spmv_dia_halo.
    ndof_block > 1 selects per-node block-Jacobi (the reference's default
    PC=BJACOBI, solverpetsc.F:206), else Jacobi.

    Returns (x (N,) on every rank, SolveStats)."""
    offsets = tuple(offsets)
    P_ = b_l.shape[0]
    krylov = _krylov_body(method)
    w = halo_width(offsets)
    if w > P_:
        raise ValueError(f"halo width {w} exceeds the {P_} rows of a rank")
    A_l = DIAMatrix(vals=vals_l, offsets=offsets, n_rows=P_)
    if b_l.is_cuda:
        def operator(x_l):
            return spmv_dia_halo_b1(A_l, x_l, w)
    else:
        def operator(x_l):
            return spmv_dia_halo(offsets, vals_l, x_l, w)

    if ndof_block > 1 and P_ % ndof_block == 0:
        precond = block_jacobi_dia_preconditioner(offsets, vals_l,
                                                  ndof_block)
    else:
        d0 = offsets.index(0) if 0 in offsets else None
        diag = vals_l[d0] if d0 is not None else torch.zeros_like(b_l)
        precond = jacobi_preconditioner(diag)
    dot, dot2 = _reduced_dots()
    x_l, stats = krylov(operator, b_l, precond, rtol, maxiter, dot, dot2)
    return _gathered(x_l), stats
