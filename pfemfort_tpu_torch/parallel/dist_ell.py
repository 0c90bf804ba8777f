# Ported from pfemfort_tpu/parallel/dist_ell.py (build_dist_ell_setup, build_ell_halo, build_ell_halo_hybrid, prepare_hybrid_local, spmv_ell_halo, spmv_ell_halo_hybrid, assemble_ell_local).
"""Distributed (per-rank) implicit assembly and SpMV for UNSTRUCTURED meshes.

The reference assembles element-partitioned on ANY METIS-partitioned mesh:
each rank loops over its own elements, and entries whose row another rank
owns are stashed and exchanged during MatAssemblyBegin/End
(PFEMFort src/triapoissonparallelimpl1.F:849-905, solverpetsc.F:447-468).
parallel/dist_assembly.py covers the lattice (DIA) case; this module is the
general-graph form over the ELL layout:

  * equations get shard-contiguous numbering (parallel/shard.py) from an
    RCB/greedy element partition, so rank s owns rows [s*P, (s+1)*P);
  * each element is assembled by its partition's rank; entries whose ROW
    another rank owns are ghost entries (the PETSc stash);
  * set-up (`build_dist_ell_setup`): every rank builds the shard-ordered
    pattern on the host, then, on its device, only its own block: the
    destinations of its elements' entries, the unique ghost slots it sends
    to each owner, and the sorted scatter over [own ELL | send windows |
    own rhs | dropped].  One all_reduce(MAX) gives emax, w_mat, w_rhs and
    every pair's window size; one point-to-point exchange of index arrays
    tells each owner which of its local slots every sender's window
    carries, as PETSc's stash does.  No rank computes another rank's
    elements;
  * assembly (`assemble_ell_local`): one ordered segment sum, the windows
    sent to their owners, two small ordered segment sums that fold the
    received windows in, in source-rank order;
  * SpMV (`spmv_ell_halo`): each rank multiplies its (P, K) block in a
    ghost-extended column space [own P rows | S*Wx ghost slots], after a
    per-product ghost exchange of the x values each reader asked for at
    set-up (`build_ell_halo`), the PETSc VecScatter of MatMult.  On a card
    tensor the product is kernel B2 (sparse/ell_spmv_cuda.py:ell_spmv) on
    the block laid out once in the sliced layout with n_cols = P + S*Wx, so
    the pad column P + S*Wx is a sentinel the kernel drops; on a CPU
    tensor it is spmv_sliced on the same layout;
  * the per-rank hybrid (`build_ell_halo_hybrid`, `spmv_ell_halo_hybrid`;
    sparse/hybrid.py's split applied to a rank's block): the own-own
    couplings on the local diagonals c - r that are dense over all ranks
    go to a (D, P) DIA block that kernel B1 multiplies by the rank's own
    x_l (a local diagonal never leaves the rank's rows, so no ghost is
    read); every other live slot, the ghost columns included, goes to a
    sliced (P, P + S*Wx) remainder on kernel B2 and the ghost-extended
    vector, with the same sentinel column.  Every rank picks the same
    diagonals from one all_reduce(SUM) of its census.  The float32
    solves of drivers/sharded.py take it, as the JAX package's do.

Every exchange is pairs of `batch_isend_irecv`, one pair for each non-empty
window, on both backends: gloo has no all_to_all (the JAX package's one
collective), and NCCL has batch_isend_irecv too, so one code path serves
both.  A rank with nothing to exchange posts nothing (an empty batch
raises), so a world of one rank posts nothing at all.  Every rank calls
these functions together.

The JAX package's TPU packing of the ghost-extended block (its slot-gather
plans, their V cap and int32 checks, and the hybrid's
`Prow + S*Wx + 1 <= 2^21` gate) is not carried: B2 reads the sliced
layout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pfemfort_tpu_torch.assembly.assemble import Segments
from pfemfort_tpu_torch.elements.geometry import rank_element_coords
from pfemfort_tpu_torch.mesh.core import Mesh
from pfemfort_tpu_torch.parallel.shard import ShardedSystem, \
    build_sharded_system
from pfemfort_tpu_torch.sparse.dia_spmv_cuda import dia_spmv
from pfemfort_tpu_torch.sparse.ell_spmv_cuda import ell_spmv
from pfemfort_tpu_torch.sparse.formats import round_up
from pfemfort_tpu_torch.sparse.hybrid import HybridMatrix, HybridPlan, \
    dense_offsets, diagonal_counts, split_on_offsets
from pfemfort_tpu_torch.sparse.sliced import SlicedELL


@dataclasses.dataclass
class DistELLSetup:
    """One rank's element block and exchange plan for distributed ELL
    assembly: the JAX package's per-shard arrays at index `rank`."""
    sys: ShardedSystem
    ell_k: int                   # K
    w_mat: int                   # matrix send slots per (src, dst) pair
    w_rhs: int                   # rhs send slots per pair
    emax: int                    # padded elements per rank
    rank: int                    # the rank whose block this is
    coords: np.ndarray           # (npe, ndim, Emax) float64
    ubc: np.ndarray              # (ns, Emax) float64 applied BC values
    perm: torch.Tensor           # (n_ent,) int64 sorted-scatter permutation
    segids: torch.Tensor         # (n_ent,) int64 sorted segment ids
    recv_mat_dest: torch.Tensor  # (S, w_mat) int64 local ELL slot or P*K
    recv_rhs_dest: torch.Tensor  # (S, w_rhs) int64 local row or P
    pair_slots: np.ndarray       # (S, S) slots sent from rank s to rank t
    elem_owner: np.ndarray       # (E,) int32 rank that assembles each element

    @property
    def n_shards(self) -> int:
        return self.sys.n_shards

    @property
    def rows_per_shard(self) -> int:
        return self.sys.rows_per_shard

    @property
    def w_pair(self) -> int:
        return self.w_mat + self.w_rhs


def _pair_unique(tgt: torch.Tensor, loc: torch.Tensor, space: int, S: int):
    """Unique (target, local id) ghost slots: (targets, local ids, slot
    within the target's window, inverse, count per target)."""
    uniq, inv = torch.unique(tgt * space + loc, sorted=True,
                             return_inverse=True)
    ut = torch.div(uniq, space, rounding_mode="floor")
    cnts = torch.bincount(ut, minlength=S)
    slot = torch.arange(len(uniq), device=uniq.device) \
        - (torch.cumsum(cnts, 0) - cnts)[ut]
    return ut, uniq % space, slot, inv, cnts


def _exchange(sends, recvs) -> None:
    """Post every (peer, tensor) send and receive as one batch and wait; a
    batch with nothing to post is skipped (an empty one raises)."""
    ops = [dist.P2POp(dist.isend, t.contiguous(), peer) for peer, t in sends]
    ops += [dist.P2POp(dist.irecv, t, peer) for peer, t in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def build_dist_ell_setup(
    mesh: Mesh,
    ndof: int,
    dirichlet: np.ndarray,
    n_shards: int,
    rank: int,
    method: str = "rcb",
    lane_pad: int = 8,
    *,
    device,
) -> DistELLSetup:
    """Partition elements, renumber rows shard-contiguously, and build rank
    `rank`'s scatter and ghost-exchange plan over the shard-ordered ELL
    pattern.  Works for ANY mesh and partition.  Every rank of the default
    process group calls it together (one all_reduce, one exchange of index
    arrays); the index arrays are built on `device`."""
    device = torch.device(device)
    sys_ = build_sharded_system(mesh, ndof, dirichlet, n_shards,
                                method=method, lane_pad=lane_pad,
                                layout="ell")
    pattern = sys_.pattern
    S, P, K = n_shards, sys_.rows_per_shard, pattern.ell_k
    n_rows = sys_.n_rows_padded
    i64 = dict(dtype=torch.int64, device=device)

    owner = sys_.elem_part.astype(np.int64)
    els = np.nonzero(owner == rank)[0]
    k = len(els)
    dofmap = sys_.dofmap
    ed = dofmap.elem_dof[els]
    mapped = np.where(ed >= 0, sys_.eq_perm[np.clip(ed, 0, None)], -1)
    ns = ed.shape[1]

    # CSR -> ELL slot lookup over the sorted (row, col) keys
    indptr = torch.as_tensor(pattern.indptr, **i64)
    row_deg = torch.diff(indptr)
    within = torch.arange(pattern.nnz, **i64) \
        - indptr[:-1].repeat_interleave(row_deg)
    uk = torch.arange(n_rows, **i64).repeat_interleave(row_deg) * n_rows \
        + torch.as_tensor(pattern.indices, **i64)

    edt = torch.as_tensor(np.ascontiguousarray(mapped.T), **i64)  # (ns, k)
    rows = edt[:, None, :].expand(ns, ns, k)
    cols = edt[None, :, :].expand(ns, ns, k)
    valid = (rows >= 0) & (cols >= 0)
    pos = torch.searchsorted(uk, torch.where(valid, rows * n_rows + cols, 0))
    lflat = (rows % P) * K + within[pos.clamp_(max=max(len(uk) - 1, 0))]
    trow = torch.where(valid, torch.div(rows, P, rounding_mode="floor"), -1)
    rvalid = edt >= 0
    r_t = torch.where(rvalid, torch.div(edt, P, rounding_mode="floor"), -1)
    r_lrow = torch.where(rvalid, edt % P, 0)

    gm = valid & (trow != rank)
    ut, ul, slot, inv, cnt_m = _pair_unique(trow[gm], lflat[gm], P * K, S)
    gr = rvalid & (r_t != rank)
    rt, rl, rslot, rinv, cnt_r = _pair_unique(r_t[gr], r_lrow[gr], P, S)

    # one all_reduce(MAX): emax, and every (src, dst) pair's slot counts,
    # each rank filling its own rows
    red = torch.zeros(1 + 2 * S * S, **i64)
    red[0] = k
    red[1 + rank * S:1 + (rank + 1) * S] = cnt_m
    red[1 + S * S + rank * S:1 + S * S + (rank + 1) * S] = cnt_r
    dist.all_reduce(red, op=dist.ReduceOp.MAX)
    red = red.cpu().numpy()
    emax = max(int(red[0]), 1)
    pair_m = red[1:1 + S * S].reshape(S, S)
    pair_r = red[1 + S * S:].reshape(S, S)
    w_mat = round_up(max(int(pair_m.max()), 1), lane_pad)
    w_rhs = round_up(max(int(pair_r.max()), 1), lane_pad)
    W = w_mat + w_rhs

    # destination id space of this rank (one sorted segment sum):
    #   [0, P*K)                     own ELL values
    #   [P*K, P*K + S*W)             send windows (t*W + slot | +w_mat)
    #   [P*K + S*W, .. + P)          own rhs rows
    #   last segment                 dropped (Dirichlet/pad) contributions
    base_send = P * K
    base_rhs = P * K + S * W
    sentinel = base_rhs + P
    mdest = torch.full((ns, ns, emax), sentinel, **i64)
    blk = torch.full((ns, ns, k), sentinel, **i64)
    own = valid & (trow == rank)
    blk[own] = lflat[own]
    blk[gm] = base_send + trow[gm] * W + slot[inv]
    mdest[:, :, :k] = blk
    rdest = torch.full((ns, emax), sentinel, **i64)
    rblk = torch.full((ns, k), sentinel, **i64)
    rown = rvalid & (r_t == rank)
    rblk[rown] = base_rhs + r_lrow[rown]
    rblk[gr] = base_send + r_t[gr] * W + w_mat + rslot[rinv]
    rdest[:, :k] = rblk
    dest_all = torch.cat([mdest.reshape(-1), rdest.reshape(-1)])
    del rows, cols, valid, pos, lflat, trow, blk, mdest, rdest, rblk
    perm = torch.sort(dest_all, stable=True).indices
    segids = dest_all[perm]

    # the stash's index lists: each sender posts, to every owner it has
    # ghosts for, the owner-local slots of its window (matrix, then rhs)
    recv_mat_dest = torch.full((S, w_mat), P * K, **i64)
    recv_rhs_dest = torch.full((S, w_rhs), P, **i64)
    sends = [(t, torch.cat([ul[ut == t], rl[rt == t]])) for t in range(S)
             if t != rank and pair_m[rank, t] + pair_r[rank, t] > 0]
    recvs = [(s, torch.empty(int(pair_m[s, rank] + pair_r[s, rank]), **i64))
             for s in range(S)
             if s != rank and pair_m[s, rank] + pair_r[s, rank] > 0]
    _exchange(sends, recvs)
    for s, buf in recvs:
        cm = int(pair_m[s, rank])
        recv_mat_dest[s, :cm] = buf[:cm]
        recv_rhs_dest[s, :len(buf) - cm] = buf[cm:]

    # padding elements reuse element 0's geometry (finite Ke, all dropped)
    coords = rank_element_coords(mesh, els, emax)
    ubc = np.zeros((ns, emax), dtype=np.float64)
    if k:
        ubc[:, :k] = dofmap.bc_values_full[dofmap.elem_nodedof[els]].T
    return DistELLSetup(
        sys=sys_, ell_k=K, w_mat=w_mat, w_rhs=w_rhs, emax=emax, rank=rank,
        coords=coords, ubc=ubc, perm=perm, segids=segids,
        recv_mat_dest=recv_mat_dest, recv_rhs_dest=recv_rhs_dest,
        pair_slots=pair_m + pair_r, elem_owner=owner.astype(np.int32))


@dataclasses.dataclass(frozen=True)
class EllLocalPlan:
    """A rank's ordered scatters for `assemble_ell_local`, made once per
    set-up by `ell_local_plan`."""
    entries: Segments      # [own ELL | send windows | own rhs | dropped]
    fold_mat: Segments     # received matrix windows -> own ELL slots
    fold_rhs: Segments     # received rhs windows -> own rows
    sends: Tuple[int, ...]     # ranks this rank's windows go to
    recvs: Tuple[int, ...]     # ranks whose windows come here
    P: int
    K: int
    w_mat: int
    w_rhs: int


def ell_local_plan(setup: DistELLSetup) -> EllLocalPlan:
    S, P, K, r = setup.n_shards, setup.rows_per_shard, setup.ell_k, \
        setup.rank
    W = setup.w_pair
    n_seg = P * K + S * W + P + 1
    pair = setup.pair_slots
    return EllLocalPlan(
        entries=Segments.from_sorted(setup.perm, setup.segids, n_seg),
        fold_mat=Segments.from_dest(setup.recv_mat_dest.reshape(-1),
                                    P * K + 1),
        fold_rhs=Segments.from_dest(setup.recv_rhs_dest.reshape(-1), P + 1),
        sends=tuple(t for t in range(S) if t != r and pair[r, t] > 0),
        recvs=tuple(s for s in range(S) if s != r and pair[s, r] > 0),
        P=P, K=K, w_mat=setup.w_mat, w_rhs=setup.w_rhs)


def assemble_ell_local(Ke: torch.Tensor, Fe: torch.Tensor,
                       plan: EllLocalPlan
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-rank ELL assembly and the stash exchange: Ke (ns, ns, Emax), Fe
    (ns, Emax) -> (vals_own (P, K), b_own (P,)) of this rank."""
    P, K = plan.P, plan.K
    W = plan.w_mat + plan.w_rhs
    base_send = P * K
    sums = plan.entries.sum(torch.cat([Ke.reshape(-1), Fe.reshape(-1)]))
    vals_own = sums[:base_send]
    send = sums[base_send:-P].reshape(-1, W)
    b_own = sums[-P:]

    # the stash exchange: recv[s] = rank s's window for this rank
    recv = send.new_zeros(send.shape)
    _exchange([(t, send[t]) for t in plan.sends],
              [(s, recv[s]) for s in plan.recvs])
    mv = plan.fold_mat.sum(recv[:, :plan.w_mat])
    rv = plan.fold_rhs.sum(recv[:, plan.w_mat:])
    return (vals_own + mv).reshape(P, K), b_own + rv


@dataclasses.dataclass(frozen=True)
class ReaderPlan:
    """The columns a rank reads from other ranks: its sorted unique ghost
    columns (padded shard-ordered ids), each one's owner and slot in that
    owner's window, and the count per owner."""
    ghosts: torch.Tensor   # (n_ghost,) int64, ascending (so owner-major)
    owner: torch.Tensor    # (n_ghost,) int64
    slot: torch.Tensor     # (n_ghost,) int64
    counts: torch.Tensor   # (S,) int64


def reader_plan(cols: torch.Tensor, rank: int, n_shards: int,
                n_rows: int) -> ReaderPlan:
    """Rank `rank`'s reader plan from its (P, K) rows of the shard-ordered
    ELL columns (sentinel n_rows), on cols' device, without a process
    group."""
    P = cols.shape[0]
    c = cols.long()
    g = c[(c != n_rows) & (torch.div(c, P, rounding_mode="floor") != rank)]
    owner, local, slot, _, counts = _pair_unique(
        torch.div(g, P, rounding_mode="floor"), g % P, P, n_shards)
    return ReaderPlan(ghosts=owner * P + local, owner=owner, slot=slot,
                      counts=counts)


def local_columns(cols: torch.Tensor, plan: ReaderPlan, rank: int,
                  n_shards: int, n_rows: int, wx: int) -> torch.Tensor:
    """The (P, K) int32 columns of rank `rank`'s rows in its ghost-extended
    column space: own columns -> [0, P), a ghost owned by rank s ->
    P + s*wx + its slot, padding -> P + S*wx."""
    P = cols.shape[0]
    c = cols.long()
    out = torch.where(c == n_rows, P + n_shards * wx, c - rank * P)
    ghost = (c != n_rows) & (torch.div(c, P, rounding_mode="floor") != rank)
    idx = torch.searchsorted(plan.ghosts, c[ghost])
    out[ghost] = P + plan.owner[idx] * wx + plan.slot[idx]
    return out.to(torch.int32)


@dataclasses.dataclass(frozen=True)
class EllHalo:
    """One rank's ghost-exchange plan for `spmv_ell_halo`."""
    n_shards: int
    rows_per_shard: int
    wx: int                    # ghost slots per (owner, reader) pair
    cols_local: torch.Tensor   # (P, K) int32, ghost-extended column ids
    sends: Tuple[Tuple[int, torch.Tensor], ...]   # (reader, rows it reads)
    recvs: Tuple[Tuple[int, int], ...]            # (owner, ghost count)

    @property
    def n_cols(self) -> int:
        """Columns of the ghost-extended block; P + S*wx is its pad."""
        return self.rows_per_shard + self.n_shards * self.wx


def build_ell_halo(sys_: ShardedSystem, rank: int, *, device) -> EllHalo:
    """Rank `rank`'s ghost-exchange plan: its reader plan, the global slot
    width Wx (one all_reduce(MAX) that also gives every (reader, owner)
    pair's count), and one point-to-point exchange in which each reader
    posts to each owner the owner-local rows it reads.  Every rank of the
    default process group calls it together."""
    S, P = sys_.n_shards, sys_.rows_per_shard
    n_rows = sys_.n_rows_padded
    cols = torch.as_tensor(sys_.pattern.ell_cols[rank * P:(rank + 1) * P],
                           device=device)
    plan = reader_plan(cols, rank, S, n_rows)
    red = torch.zeros(S * S, dtype=torch.int64, device=cols.device)
    red[rank * S:(rank + 1) * S] = plan.counts
    dist.all_reduce(red, op=dist.ReduceOp.MAX)
    pair = red.cpu().numpy().reshape(S, S)          # [reader, owner]
    wx = round_up(max(int(pair.max()), 1), 8)

    asks = [(s, plan.ghosts[plan.owner == s] % P) for s in range(S)
            if s != rank and pair[rank, s] > 0]
    answers = [(t, torch.empty(int(pair[t, rank]), dtype=torch.int64,
                               device=cols.device))
               for t in range(S) if t != rank and pair[t, rank] > 0]
    _exchange(asks, answers)
    return EllHalo(
        n_shards=S, rows_per_shard=P, wx=wx,
        cols_local=local_columns(cols, plan, rank, S, n_rows, wx),
        sends=tuple(answers),
        recvs=tuple((s, int(pair[rank, s])) for s in range(S)
                    if s != rank and pair[rank, s] > 0))


def exchange_ghosts(halo: EllHalo, x_l: torch.Tensor) -> torch.Tensor:
    """The ghost-extended vector [x_l | S*Wx ghost slots] of this rank:
    each owner sends the values its readers asked for; slots nobody
    fills stay zero (no column reads them)."""
    wx = halo.wx
    ghosts = x_l.new_zeros(halo.n_shards * wx)
    _exchange([(t, x_l[rows]) for t, rows in halo.sends],
              [(s, ghosts[s * wx:s * wx + n]) for s, n in halo.recvs])
    return torch.cat([x_l, ghosts])


def spmv_ell_halo(A_l: SlicedELL, halo: EllHalo,
                  x_l: torch.Tensor) -> torch.Tensor:
    """y_l = (A x)_l: the ghost exchange, then this rank's block on the
    ghost-extended vector (kernel B2 on a card tensor, spmv_sliced on a CPU
    one).  A_l: the rank's block laid out by
    slice_ell(halo.cols_local, halo.n_cols)."""
    return ell_spmv(A_l, exchange_ghosts(halo, x_l))


def hybrid_counts(cols_local) -> np.ndarray:
    """This rank's share of the hybrid's diagonal census: (2P - 1,) int64,
    its slots with an own column (local id < P) by local diagonal
    c - r + P - 1, from its (P, K) ghost-extended columns.  A ghost column
    is never on a local diagonal."""
    return diagonal_counts(np.asarray(cols_local))


def hybrid_offsets(counts_sum, n_shards: int, fill_threshold: float = 0.2,
                   max_d: int = 48) -> Tuple[int, ...]:
    """The dense local diagonals, from the census summed over every rank:
    those that at least `fill_threshold` of all S*P rows populate, the
    `max_d` most filled when more pass (the JAX package's rule and tie
    order), ascending.  Every rank gets the same tuple."""
    P = (len(counts_sum) + 1) // 2
    return dense_offsets(counts_sum, n_shards * P, fill_threshold, max_d)


def hybrid_split(cols_local, offsets: Tuple[int, ...],
                 n_cols: int) -> HybridPlan:
    """A rank's split of its (P, K) ghost-extended columns on `offsets`:
    dia_src (D, P), the flat index into the rank's (P, K) values of each
    diagonal entry (-1 for none), and the remainder, every other slot
    below n_cols = P + S*Wx (ghost columns included), as (P, K_rem)
    columns with sentinel n_cols and their flat sources."""
    cols = np.asarray(cols_local, dtype=np.int64)
    P, K = cols.shape
    src = np.arange(P * K, dtype=np.int64).reshape(P, K)
    return split_on_offsets(cols, src, P, offsets, n_cols)


def build_ell_halo_hybrid(halo: EllHalo, fill_threshold: float = 0.2,
                          max_d: int = 48) -> Optional[HybridPlan]:
    """This rank's hybrid split of its ghost-extended block: its census,
    one all_reduce(SUM) so that every rank picks the same diagonals, and
    its split on them.  None when no diagonal is dense (the route then
    keeps B2 on the whole block).  `hybrid_layout(plan, device)` lays it
    out once per pattern and `.pack(vals_l)` packs each assembly's values
    with one gather a part.  Every rank of the default process group calls
    it together."""
    cols = halo.cols_local.cpu().numpy()
    cnt = torch.as_tensor(hybrid_counts(cols),
                          device=halo.cols_local.device)
    dist.all_reduce(cnt)
    offsets = hybrid_offsets(cnt.cpu().numpy(), halo.n_shards,
                             fill_threshold, max_d)
    if not offsets:
        return None
    return hybrid_split(cols, offsets, halo.n_cols)


def spmv_ell_halo_hybrid(H_l: HybridMatrix, halo: EllHalo,
                         x_l: torch.Tensor) -> torch.Tensor:
    """y_l = (A x)_l through the rank's hybrid: B1 on the dense local
    diagonals and x_l, issued before the exchange since it reads no ghost,
    then B2 on the remainder and the ghost-extended vector (each wrapper
    takes its plain version on a CPU tensor).  Every ghost column lies in
    the remainder, so a rank without one reads no ghost and skips B2; it
    still sends what the other ranks read from it."""
    y = dia_spmv(H_l.dia, x_l)
    if H_l.rem is None:
        if halo.sends:
            exchange_ghosts(halo, x_l)
        return y
    return y + ell_spmv(H_l.rem, exchange_ghosts(halo, x_l))
