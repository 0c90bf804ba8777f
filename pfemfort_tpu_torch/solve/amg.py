# Ported from pfemfort_tpu/solve/amg.py (set-up, the portable V-cycle and the distributed form).
"""Smoothed-aggregation algebraic multigrid (any SPD mesh, one rank or many).

The reference's scalable-preconditioner story is PETSc's options-file
escape hatch to hypre/AMG (PFEMFort src/solverpetsc.F:1-8, 198-209).
Geometric MG (solve/multigrid.py) covers the generator lattices; THIS module
covers meshes with no lattice at all — the classic smoothed-aggregation
construction (Vanek/Mandel/Brezina):

  host set-up (numpy/scipy, once per assembled matrix; the JAX package's
  code, copied):
    * strength graph  |a_ij| > theta * sqrt(a_ii a_jj)
    * greedy root aggregation (host library, host_native.py)
    * tentative P0 = piecewise-constant over aggregates
    * smoothed P = (I - omega D^-1 A) P0, omega = 4/3 / lambda_max
      (Gershgorin bound on D^-1 A)
    * Galerkin coarse operator A_c = P^T A P (scipy sparse product), with
      filtering and diagonal lumping from level 2 down, and a stall guard
    * recurse until the coarsest level fits a dense inverse

  V-cycle: damped-Jacobi smoothing, ELL level operators and transfers.
  `samg_preconditioner` here is the portable form (every block laid out
  sliced once, every product through sparse/ell_spmv_cuda.py: kernel B2 on
  the card, the plain gather on the CPU); solve/amg_device.py routes each
  block to B1, B2 or a dense product and applies the transfers factored.

  Distributed form (`build_dist_samg`, `dist_samg_preconditioner`): the
  whole hierarchy is built on the host of every rank, identically; each
  rank keeps its row block of the level-0 tentative prolongator (and its
  transpose) and smooths the fine level with the sharded solve's own
  operator; the coarse residual is one all_reduce and the tail runs,
  replicated, on the routed blocks.

The reference findings in this construction are reproduced, not fixed
(ROADMAP C): `aggressive_levels` stays 0 and the lumping can shrink a
diagonal.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed

from pfemfort_tpu_torch import host_native
from pfemfort_tpu_torch.sparse.ell_spmv_cuda import ell_spmv
from pfemfort_tpu_torch.sparse.formats import ELLMatrix, round_up
from pfemfort_tpu_torch.sparse.sliced import SlicedELL, ell_to_sliced, \
    slice_ell


# ---------------------------------------------------------------------------
# host-side set-up
# ---------------------------------------------------------------------------

def _aggregate2(S_indptr, S_indices, n: int) -> Tuple[np.ndarray, int]:
    """Double (pairwise-composite) aggregation: aggregate the strength
    graph, then the AGGREGATE graph, and compose (radius-2 aggregates)."""
    import scipy.sparse as ssp

    agg_a, na_a = _aggregate(S_indptr, S_indices, n)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(S_indptr))
    ra = agg_a[rows]
    ca = agg_a[S_indices]
    off = ra != ca
    Sagg = ssp.csr_matrix(
        (np.ones(int(off.sum()), np.float32), (ra[off], ca[off])),
        shape=(na_a, na_a))
    agg_b, na_b = _aggregate(Sagg.indptr, Sagg.indices.astype(np.int64),
                             na_a)
    return agg_b[agg_a], na_b


def _aggregate(S_indptr, S_indices, n: int) -> Tuple[np.ndarray, int]:
    """Greedy root aggregation over the strength graph (host library):
    (agg id per node, n_agg)."""
    return host_native.samg_aggregate(S_indptr, S_indices, n)


def _rigid_body_modes(coords_rows: np.ndarray, comp: np.ndarray,
                      ndof: int) -> np.ndarray:
    """Near-nullspace B (n, k) for elasticity: translations + rotations.

    coords_rows: per-ROW node coordinates; comp: per-row dof component.
    ndof=3 -> k=6 (3 translations, 3 rotations); ndof=2 -> k=3."""
    n = coords_rows.shape[0]
    x, y = coords_rows[:, 0], coords_rows[:, 1]
    z = coords_rows[:, 2] if coords_rows.shape[1] > 2 else np.zeros(n)
    cols = []
    for d in range(ndof):                      # translations
        cols.append((comp == d).astype(np.float64))
    if ndof >= 2:                              # rotation about z: (-y, x)
        cols.append(np.where(comp == 0, -y, np.where(comp == 1, x, 0.0)))
    if ndof == 3:                              # about x: (0, -z, y)
        cols.append(np.where(comp == 1, -z, np.where(comp == 2, y, 0.0)))
        # about y: (z, 0, -x)
        cols.append(np.where(comp == 0, z, np.where(comp == 2, -x, 0.0)))
    return np.stack(cols, axis=1)


def _tentative_from_nullspace(agg_of_row: np.ndarray, n_agg: int,
                              B: np.ndarray):
    """Aggregate-wise QR of the near-nullspace: P0 (n, n_agg*k) with the
    orthonormal Q blocks, and the coarse nullspace Bc (n_agg*k, k) from the
    R factors (the standard SA recursion).  Rank-deficient aggregates keep
    zero columns."""
    import scipy.sparse as ssp

    n, k = B.shape
    order = np.argsort(agg_of_row, kind="stable")
    sizes = np.bincount(agg_of_row, minlength=n_agg)
    starts = np.zeros(n_agg + 1, dtype=np.int64)
    np.cumsum(sizes, out=starts[1:])
    P0_rows, P0_cols, P0_vals = [], [], []
    Bc = np.zeros((n_agg * k, k), dtype=np.float64)
    # bucket aggregates by size: one batched QR per size class
    for m in np.unique(sizes):
        if m == 0:
            continue
        aggs = np.nonzero(sizes == m)[0]
        idx = starts[aggs][:, None] + np.arange(m)[None, :]
        rws = order[idx]                       # member rows per aggregate
        Q, R = np.linalg.qr(B[rws])            # reduced: (m, min(m, k))
        kk = Q.shape[2]
        # zero out columns whose pivot is ~0 (rank deficiency)
        piv = np.abs(R[:, np.arange(kk), np.arange(kk)])
        scale = np.maximum(np.abs(R).max(axis=(1, 2)), 1e-300)
        ok = piv > 1e-10 * scale[:, None]
        Q = np.where(ok[:, None, :], Q, 0.0)
        R = np.where(ok[:, :, None], R, 0.0)
        P0_rows.append(np.broadcast_to(rws[:, :, None],
                                       (len(aggs), m, kk)).ravel())
        P0_cols.append((aggs[:, None, None] * k
                        + np.arange(kk)[None, None, :]
                        + np.zeros((1, m, 1), np.int64)).ravel())
        P0_vals.append(Q.ravel())
        rows_bc = (aggs[:, None] * k + np.arange(kk)[None, :]).ravel()
        Bc[rows_bc] = R.reshape(len(aggs) * kk, k)
    P0 = ssp.csr_matrix(
        (np.concatenate(P0_vals),
         (np.concatenate(P0_rows), np.concatenate(P0_cols))),
        shape=(n, n_agg * k))
    return P0, Bc


def _csr_to_ell(S, lane_pad: int = 8):
    """scipy CSR -> padded-ELL numpy (cols sentinel = n_cols)."""
    S = S.tocsr()
    n, m = S.shape
    deg = np.diff(S.indptr)
    K = int(round_up(max(int(deg.max(initial=0)), 1), lane_pad))
    cols = np.full((n, K), m, dtype=np.int32)
    vals = np.zeros((n, K), dtype=S.dtype)
    within = np.arange(S.nnz, dtype=np.int64) - np.repeat(S.indptr[:-1], deg)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols[rows, within] = S.indices
    vals[rows, within] = S.data
    return cols, vals


class SAMGArrays(NamedTuple):
    """Per-level blocks as padded ELL.

    The SMOOTHED prolongator P = (I - omega D^-1 A) P0 is stored two ways:
    directly (p / pt, the portable V-cycle's form) and FACTORED (the
    tentative p0 / p0t plus omega), so that solve/amg_device.py can apply
    the smoothing factor through the level operator and store only the
    skinny tentative blocks (one nonzero per fine row and mode)."""
    a: Tuple[ELLMatrix, ...]          # level operators
    p: Tuple[ELLMatrix, ...]          # prolongators fine <- coarse
    pt: Tuple[ELLMatrix, ...]         # restrictions P^T
    p0: Tuple[ELLMatrix, ...]         # TENTATIVE prolongators P0
    p0t: Tuple[ELLMatrix, ...]        # P0^T
    omegas: Tuple[float, ...]         # per-level smoothing weight omega_p
    inv_diags: Tuple[torch.Tensor, ...]
    coarse_inv: torch.Tensor          # dense inverse of the coarsest level


@dataclasses.dataclass(frozen=True)
class SAMGMeta:
    sizes: Tuple[int, ...]            # rows per level
    nu: int
    omega_smooth: float               # Jacobi damping in the cycle


def build_samg(indptr: np.ndarray, indices: np.ndarray, vals: np.ndarray,
               n: int, ndof: int = 1, theta: float = 0.08,
               coarsest_max: int = 800, max_levels: int = 12,
               nu: Optional[int] = None,
               omega_smooth: Optional[float] = None,
               node_block: int = 1,
               nullspace: Optional[np.ndarray] = None,
               min_coarsen_ratio: float = 1.5,
               filter_tol: float = 0.01,
               filter_from_level: int = 2,
               aggressive_levels: int = 0,
               dtype=torch.float32, *, device
               ) -> Optional[Tuple[SAMGArrays, SAMGMeta]]:
    """Build the hierarchy from a host CSR of the (reduced, SPD) system;
    the blocks are staged on `device` in `dtype`.  None when the system
    cannot be coarsened or stalls while too big for a dense coarsest
    inverse (the caller falls back to Jacobi and says so).

    `node_block` > 1: rows come in aligned blocks of that size (every node
    owns node_block consecutive rows); aggregation then runs on the NODE
    graph and the tentative prolongator keeps one column per aggregate per
    COMPONENT.  With node_block=1 (solve_implicit's reduced numbering has no
    alignment guarantee) aggregation is dof-granular."""
    import scipy.sparse as ssp

    # ndof-aware smoothing: vector problems need nu=2 sweeps at omega=0.6
    if nu is None:
        nu = 1 if ndof == 1 else 2
    if omega_smooth is None:
        omega_smooth = 0.7 if ndof == 1 else 0.6

    # size-adaptive coarsest: every extra level adds fixed V-cycle latency,
    # while the dense coarsest inverse is nearly free to apply
    coarsest_max = min(max(coarsest_max, n // 200), 6000)
    A = ssp.csr_matrix((vals, indices, indptr), shape=(n, n))
    nb = node_block if (node_block > 1 and n % node_block == 0) else 1
    B_ns = None
    if nullspace is not None and nb > 1:
        B_ns = np.asarray(nullspace, dtype=np.float64)
        if B_ns.shape[0] != n:
            raise ValueError(f"nullspace has {B_ns.shape[0]} rows, not {n}")
    levels_a: List = [A]
    levels_p: List = []
    levels_p0: List = []
    sizes = [n]
    while sizes[-1] > coarsest_max and len(sizes) < max_levels:
        Al = levels_a[-1].tocsr()
        nl = Al.shape[0]
        d = np.asarray(Al.diagonal(), dtype=np.float64)
        d_safe = np.where(d > 0, d, 1.0)
        # strength-of-connection filter
        rows = np.repeat(np.arange(nl, dtype=np.int64), np.diff(Al.indptr))
        cols = Al.indices.astype(np.int64)
        av = np.abs(np.asarray(Al.data, dtype=np.float64))
        nbl = nb if (nb > 1 and nl % nb == 0) else 1
        aggf = (_aggregate2 if len(sizes) <= aggressive_levels
                else _aggregate)
        # theta backoff: deep coarse operators become diagonally dominant
        # and a fixed threshold can leave the strength graph empty; retry
        # with a weaker threshold, then with every off-diagonal connection
        made_progress = False
        for th_try in (theta, 0.1 * theta, 0.0):
            thr = th_try * np.sqrt(d_safe[rows] * d_safe[cols])
            keep = (av > thr) & (rows != cols)
            if nbl > 1:
                rb_p = rows[keep] // nbl
                cb_p = cols[keep] // nbl
                off_p = rb_p != cb_p
                Sp = ssp.csr_matrix(
                    (np.ones(int(off_p.sum()), np.float32),
                     (rb_p[off_p], cb_p[off_p])),
                    shape=(nl // nbl, nl // nbl))
                _, na_p = aggf(Sp.indptr, Sp.indices.astype(np.int64),
                               nl // nbl)
                if na_p * min_coarsen_ratio <= nl // nbl:
                    made_progress = True
                    break
            else:
                Sp = ssp.csr_matrix(
                    (np.ones(int(keep.sum()), np.float32),
                     (rows[keep], cols[keep])), shape=(nl, nl))
                _, na_p = aggf(Sp.indptr, Sp.indices.astype(np.int64), nl)
                if na_p * min_coarsen_ratio <= nl:
                    made_progress = True
                    break
        if not made_progress:
            break
        if nbl > 1:
            # condense to the node-block graph, aggregate nodes, expand the
            # tentative prolongator per component
            rb_, cb_ = rows[keep] // nbl, cols[keep] // nbl
            off = rb_ != cb_
            S = ssp.csr_matrix(
                (np.ones(int(off.sum()), np.float32),
                 (rb_[off], cb_[off])), shape=(nl // nbl, nl // nbl))
            agg_n, n_agg_n = aggf(S.indptr, S.indices.astype(np.int64),
                                  nl // nbl)
            # stall guard: near-singleton aggregation densifies every
            # deeper Galerkin operator; let the dense coarsest inverse
            # absorb this level instead
            if n_agg_n * min_coarsen_ratio > nl // nbl:
                break
            r_all = np.arange(nl, dtype=np.int64)
            if B_ns is not None:
                P0, B_next = _tentative_from_nullspace(
                    agg_n[r_all // nbl], n_agg_n, B_ns)
                n_agg = P0.shape[1]
                B_ns = B_next
                nb = B_ns.shape[1]        # coarse blocks = k modes
            else:
                agg_cols = agg_n[r_all // nbl] * nbl + (r_all % nbl)
                n_agg = n_agg_n * nbl
                P0 = ssp.csr_matrix(
                    (np.ones(nl, np.float64), (r_all, agg_cols)),
                    shape=(nl, n_agg))
        else:
            S = ssp.csr_matrix((np.ones(int(keep.sum()), np.float32),
                                (rows[keep], cols[keep])), shape=(nl, nl))
            agg, n_agg = aggf(S.indptr, S.indices.astype(np.int64), nl)
            if n_agg * min_coarsen_ratio > nl:   # stall guard (see above)
                break
            # tentative piecewise-constant prolongator
            P0 = ssp.csr_matrix(
                (np.ones(nl, np.float64),
                 (np.arange(nl, dtype=np.int64), agg)), shape=(nl, n_agg))
        absrow = np.asarray(np.abs(Al).sum(axis=1)).reshape(-1)
        lam = float(np.max(absrow / d_safe))       # Gershgorin on D^-1 A
        omega_p = (4.0 / 3.0) / max(lam, 1e-30)
        Dinv = ssp.diags(1.0 / d_safe)
        P = (P0 - omega_p * (Dinv @ (Al @ P0))).tocsr()
        Ac = (P.T @ Al @ P).tocsr()
        Ac.sum_duplicates()
        if filter_tol > 0 and len(sizes) >= filter_from_level:
            # Galerkin filtering: drop |a_ij| < tol*sqrt(a_ii a_jj)
            # off-diagonals and LUMP them into the diagonal (keeps row
            # sums); the first coarse operator is kept exact
            dA = np.asarray(Ac.diagonal(), dtype=np.float64)
            ds = np.sqrt(np.abs(np.where(dA != 0, dA, 1.0)))
            rw = np.repeat(np.arange(Ac.shape[0], dtype=np.int64),
                           np.diff(Ac.indptr))
            cw = Ac.indices.astype(np.int64)
            av = np.asarray(Ac.data, dtype=np.float64)
            drop = ((np.abs(av) < filter_tol * ds[rw] * ds[cw])
                    & (rw != cw))
            if drop.any():
                lump = np.zeros(Ac.shape[0], dtype=np.float64)
                np.add.at(lump, rw[drop], av[drop])
                keep = ~drop
                Ac = ssp.csr_matrix(
                    (av[keep], (rw[keep], cw[keep])), shape=Ac.shape)
                Ac = (Ac + ssp.diags(lump)).tocsr()
                Ac.sum_duplicates()
        levels_p.append(P)
        levels_p0.append((P0.tocsr(), omega_p))
        levels_a.append(Ac)
        sizes.append(n_agg)

    if len(sizes) == 1:
        return None                # could not coarsen at all
    if sizes[-1] > max(4 * coarsest_max, 8192):
        return None                # stuck while too big for a dense inverse

    def ell(S):
        c, v = _csr_to_ell(S)
        return ELLMatrix(cols=torch.as_tensor(c, device=device),
                         vals=torch.as_tensor(v, dtype=dtype, device=device),
                         n_cols=S.shape[1])

    inv_d = []
    for Al in levels_a:
        d = np.asarray(Al.diagonal(), dtype=np.float64)
        dinv = np.zeros_like(d)
        np.divide(1.0, d, out=dinv, where=d != 0)
        inv_d.append(torch.as_tensor(dinv, dtype=dtype, device=device))
    Ad = np.asarray(levels_a[-1].toarray(), dtype=np.float64)
    dz = np.abs(np.diag(Ad)) < 1e-290       # padding/empty aggregates
    if dz.any():
        Ad[dz, :] = 0.0
        Ad[:, dz] = 0.0
        Ad[dz, dz] = 1.0
    arrays = SAMGArrays(
        a=tuple(ell(Al) for Al in levels_a),
        p=tuple(ell(P) for P in levels_p),
        pt=tuple(ell(P.T.tocsr()) for P in levels_p),
        p0=tuple(ell(P0) for P0, _ in levels_p0),
        p0t=tuple(ell(P0.T.tocsr()) for P0, _ in levels_p0),
        omegas=tuple(float(om) for _, om in levels_p0),
        inv_diags=tuple(inv_d),
        coarse_inv=torch.as_tensor(np.linalg.inv(Ad), dtype=dtype,
                                   device=device))
    meta = SAMGMeta(sizes=tuple(sizes), nu=nu, omega_smooth=omega_smooth)
    return arrays, meta


# ---------------------------------------------------------------------------
# the portable V-cycle
# ---------------------------------------------------------------------------

def _vcycle(blocks, arrs: SAMGArrays, meta: SAMGMeta, level: int,
            r: torch.Tensor) -> torch.Tensor:
    a, p, pt = blocks
    last = len(arrs.a) - 1
    if level == last:
        return arrs.coarse_inv @ r
    Dinv = arrs.inv_diags[level]
    om = meta.omega_smooth
    spmv = lambda x: ell_spmv(a[level], x)

    e = om * Dinv * r
    for _ in range(meta.nu - 1):
        e = e + om * Dinv * (r - spmv(e))
    rc = ell_spmv(pt[level], r - spmv(e))
    ec = _vcycle(blocks, arrs, meta, level + 1, rc)
    e = e + ell_spmv(p[level], ec)
    for _ in range(meta.nu):
        e = e + om * Dinv * (r - spmv(e))
    return e


def samg_preconditioner(arrs: SAMGArrays, meta: SAMGMeta) -> Callable:
    """r -> M^-1 r: one symmetric V(nu, nu) cycle (SPD; valid inside CG).
    The level operators and transfers are laid out sliced here, once."""
    blocks = tuple(tuple(ell_to_sliced(A) for A in group)
                   for group in (arrs.a, arrs.p, arrs.pt))
    return lambda r: _vcycle(blocks, arrs, meta, 0, r)


# ---------------------------------------------------------------------------
# distributed form: per-rank fine smoothing + replicated algebraic tail
# (pfemfort_tpu/solve/amg.py:513-617)
# ---------------------------------------------------------------------------

class DistSAMG(NamedTuple):
    """One rank's share of a distributed SA-AMG hierarchy: its row block of
    the level-0 TENTATIVE prolongator and that block's transpose (both laid
    out sliced on the rank's device), the level-0 smoothing weight, and the
    replicated tail, levels 1+ routed as solve/amg_device.py routes a
    single-device hierarchy (SAMGDevice, with its own level-0 operator).

    The fine operator itself is not here: the distributed Krylov solve has
    it (the per-rank ELL block with the ghost exchange).  Transfers are
    FACTORED: P^T rf = P0^T (I - om0 A D^-1) rf and P ec = (I - om0 D^-1 A)
    (P0 ec), the smoothing factor applied through that operator."""
    p0: SlicedELL                 # (P, n_coarse) this rank's P0 rows
    p0t: SlicedELL                # (n_coarse, P) their transpose
    om0: float                    # level-0 prolongator smoothing weight
    tail: object                  # solve/amg_device.py:SAMGDevice
    metas: Tuple[SAMGMeta, SAMGMeta]   # (whole hierarchy, tail)


def dist_samg_from_blocks(p0_cols_l: np.ndarray, p0_vals_l: np.ndarray,
                          om0: float, tail: SAMGArrays,
                          metas: Tuple[SAMGMeta, SAMGMeta],
                          dtype=torch.float32, *, device) -> DistSAMG:
    """A rank's DistSAMG from its (P, K0) tentative-prolongator rows (host
    arrays, sentinel column n_coarse), the level-0 weight and the tail's
    blocks.  The transpose (n_coarse, P) is formed on the host once, so the
    restriction is a product (kernel B2), not a scatter: no atomics, and the
    same bits on every run."""
    import scipy.sparse as ssp

    from pfemfort_tpu_torch.solve.amg_device import build_samg_device

    n_coarse = int(metas[1].sizes[0])
    cols = np.asarray(p0_cols_l, dtype=np.int64)
    vals = np.asarray(p0_vals_l, dtype=np.float64)
    P = cols.shape[0]
    ok = cols < n_coarse
    rows = np.broadcast_to(np.arange(P, dtype=np.int64)[:, None], cols.shape)
    pt = ssp.csr_matrix((vals[ok], (cols[ok], rows[ok])),
                        shape=(n_coarse, P))
    t_cols, t_vals = _csr_to_ell(pt)
    as_dev = lambda c, v, n: slice_ell(
        torch.as_tensor(c.astype(np.int32), device=device), n).pack(
        torch.as_tensor(v, dtype=dtype, device=device))
    return DistSAMG(
        p0=as_dev(cols, vals, n_coarse), p0t=as_dev(t_cols, t_vals, P),
        om0=float(om0),
        tail=build_samg_device(tail, metas[1].sizes, dtype=dtype,
                               device=device),
        metas=metas)


def build_dist_samg(indptr, indices, vals, n_rows_padded: int,
                    n_shards: int, rank: int, ndof: int = 1,
                    coords_rows: Optional[np.ndarray] = None,
                    comp_rows: Optional[np.ndarray] = None,
                    dtype=torch.float32, *, device, **kw
                    ) -> Optional[DistSAMG]:
    """Build the global SA hierarchy from the shard-ordered padded system
    (zero padding rows aggregate to singletons and never couple), on the
    host, identically on every rank, and keep rank `rank`'s share of it
    (`DistSAMG`) on `device`.  The shard layout is node-aligned for
    ndof > 1 (parallel/shard.py), so aggregation runs on the node graph;
    with per-row coordinates the tentative prolongators carry the rigid-body
    near-nullspace (translations and rotations).  None when the system does
    not coarsen (the caller then runs Jacobi and says so)."""
    ns = None
    if ndof > 1 and coords_rows is not None and comp_rows is not None:
        ns = _rigid_body_modes(np.asarray(coords_rows),
                               np.asarray(comp_rows), ndof)
    built = build_samg(indptr, indices, vals, n_rows_padded, ndof=ndof,
                       node_block=ndof, nullspace=ns, dtype=dtype,
                       device="cpu", **kw)
    if built is None:
        return None
    arrs, meta = built
    if len(arrs.a) < 2:
        return None
    P = n_rows_padded // n_shards
    p0 = arrs.p0[0]
    tail = SAMGArrays(a=arrs.a[1:], p=arrs.p[1:], pt=arrs.pt[1:],
                      p0=arrs.p0[1:], p0t=arrs.p0t[1:],
                      omegas=arrs.omegas[1:], inv_diags=arrs.inv_diags[1:],
                      coarse_inv=arrs.coarse_inv)
    tail_meta = SAMGMeta(sizes=meta.sizes[1:], nu=meta.nu,
                         omega_smooth=meta.omega_smooth)
    sl = slice(rank * P, (rank + 1) * P)
    return dist_samg_from_blocks(
        p0.cols[sl].numpy(), p0.vals[sl].to(torch.float64).numpy(),
        arrs.omegas[0], tail, (meta, tail_meta), dtype=dtype, device=device)


def dist_samg_preconditioner(amg: DistSAMG, inv_diag_l: torch.Tensor,
                             spmv_l: Callable) -> Callable:
    """r_l -> M^-1 r_l on this rank.  `spmv_l`: the rank's fine operator
    (the distributed solve's own ghost-exchange product, kernel B2 on the
    card); `inv_diag_l`: 1/diag of the rank's rows.  Build it outside the
    Krylov loop.

    Per application: 2*(nu+1) ghost exchanges inside spmv_l, the
    restriction P0_s^T rf2 as one B2 product on the transposed block and
    ONE all_reduce(SUM) of the O(N_coarse) coarse residual, the replicated
    tail V-cycle (the same bits on every rank: its input is that
    all_reduce's result and nothing in it uses atomics), the prolongation
    as one B2 product on the P0_s block."""
    from pfemfort_tpu_torch.solve.amg_device import _vcycle_device

    meta, tail_meta = amg.metas
    om, om0 = meta.omega_smooth, amg.om0

    def precond(r_l):
        e = om * inv_diag_l * r_l
        for _ in range(meta.nu - 1):
            e = e + om * inv_diag_l * (r_l - spmv_l(e))
        rf = r_l - spmv_l(e)
        rf2 = rf - om0 * spmv_l(inv_diag_l * rf)
        rc = ell_spmv(amg.p0t, rf2)
        torch.distributed.all_reduce(rc)
        ec = _vcycle_device(amg.tail, tail_meta, 0, rc, None)
        pe = ell_spmv(amg.p0, ec)
        e = e + pe - om0 * inv_diag_l * spmv_l(pe)
        for _ in range(meta.nu):
            e = e + om * inv_diag_l * (r_l - spmv_l(e))
        return e

    return precond
