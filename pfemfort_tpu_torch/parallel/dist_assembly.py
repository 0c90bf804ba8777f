# Ported from pfemfort_tpu/parallel/dist_assembly.py.
"""Distributed (per-rank) implicit assembly on the DIA layout.

The reference's parallel design is each MPI rank assembling ONLY its own
elements, with off-rank entries stashed and exchanged during
MatAssemblyBegin/End (PFEMFort src/triapoissonparallelimpl1.F:849-905,
solverpetsc.F:447-468).  Here:

  * equations get shard-contiguous numbering (parallel/shard.py), so rank s
    owns rows [s*P, (s+1)*P);
  * every element is assigned to the rank of its MINIMUM row.  Every entry
    of an element pairs two of its own equations, so its rows span at most
    the matrix bandwidth, and all its entries land in [base, base + P + w)
    for ANY partition;
  * each rank sums its own element block into an extended local (D, P + w)
    DIA slab and (P + w) rhs with the port's deterministic sorted segment
    sums (assembly/assemble.py:Segments; never index_add_, whose atomics
    make CUDA sums wander), then sends the [P, P + w) spill to its right
    neighbour, one point-to-point send of the values and one of the rhs,
    and adds what it receives into its rows [0, w);
  * the same inputs give the same bits on every run, and a rank's device
    never holds more than its own block.

`build_dist_setup` is host numpy: every rank builds the shard-ordered
pattern and the element owners, then the coordinates, local rows and BC
values of its own elements alone, and moves them to its device.  (The JAX
package's single controller built every shard's block.)
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from pfemfort_tpu_torch.assembly.assemble import Segments
from pfemfort_tpu_torch.elements.geometry import rank_element_coords
from pfemfort_tpu_torch.mesh.core import Mesh
from pfemfort_tpu_torch.parallel.halo import halo_width
from pfemfort_tpu_torch.parallel.shard import ShardedSystem, \
    build_sharded_system


@dataclasses.dataclass
class DistSetup:
    """One rank's host-side element block for distributed DIA assembly."""
    sys: ShardedSystem
    offsets: Tuple[int, ...]      # DIA offsets over padded shard-ordered rows
    w: int                        # halo width (rows), lane-padded
    emax: int                     # padded elements per shard
    rank: int                     # the shard whose block this is
    coords: np.ndarray            # (npe, ndim, Emax) float64
    edt: np.ndarray               # (ns, Emax) int32 LOCAL rows, -1 = drop
    ubc: np.ndarray               # (ns, Emax) float64 applied BC values
    elem_owner: np.ndarray        # (E,) shard that assembles each element

    @property
    def n_shards(self) -> int:
        return self.sys.n_shards

    @property
    def rows_per_shard(self) -> int:
        return self.sys.rows_per_shard


def build_dist_setup(
    mesh: Mesh,
    ndof: int,
    dirichlet: np.ndarray,
    n_shards: int,
    rank: int,
    method: str = "slab",
    lane_pad: int = 8,
) -> DistSetup:
    """Build rank `rank`'s element block over a shard-contiguous DIA
    pattern: the JAX package's per-shard arrays coords_s[rank],
    edt_s[rank] and ubc_s[rank].

    Raises ValueError when the pattern is not DIA-structured or the halo
    exceeds a shard.
    """
    sys_ = build_sharded_system(mesh, ndof, dirichlet, n_shards,
                                method=method, lane_pad=lane_pad,
                                layout="dia")
    pattern = sys_.pattern
    if pattern.layout != "dia":
        raise ValueError("pattern is not DIA-structured")
    offsets = pattern.dia_offsets
    w = halo_width(offsets, lane_pad)
    P = sys_.rows_per_shard
    if w > P:
        raise ValueError(f"halo width {w} exceeds shard rows {P}")

    edt = pattern.elem_dof_t                     # (ns, E) padded global rows
    ns = edt.shape[0]
    valid = edt >= 0
    # Owner = shard of the element's minimum valid row; all its entries then
    # lie in [owner*P, owner*P + P + w).  All-BC elements contribute nothing.
    min_row = np.where(valid, edt, np.iinfo(np.int32).max).min(axis=0)
    owner = np.where(min_row < np.iinfo(np.int32).max,
                     np.minimum(min_row // P, n_shards - 1),
                     0).astype(np.int32)

    counts = np.bincount(owner, minlength=n_shards)
    emax = max(int(counts.max()), 1)

    dofmap = sys_.dofmap
    els = np.nonzero(owner == rank)[0]
    k = len(els)
    # padding elements reuse element 0's geometry (finite Ke, all rows -1)
    coords = rank_element_coords(mesh, els, emax)
    edt_l = np.full((ns, emax), -1, dtype=np.int32)
    ubc = np.zeros((ns, emax), dtype=np.float64)
    if k:
        loc = edt[:, els].astype(np.int64)
        edt_l[:, :k] = np.where(loc >= 0, loc - rank * P, -1)
        ubc[:, :k] = dofmap.bc_values_full[dofmap.elem_nodedof[els]].T
    return DistSetup(sys=sys_, offsets=offsets, w=w, emax=emax, rank=rank,
                     coords=coords, edt=edt_l, ubc=ubc, elem_owner=owner)


@dataclasses.dataclass(frozen=True)
class LocalPlan:
    """A rank's sorted scatters into its extended (D, P + w) slab and
    (P + w) rhs, made once per pattern by `local_plan`."""
    mat: Segments
    rhs: Segments
    n_diag: int
    P: int
    w: int


def local_plan(edt_local: torch.Tensor, offsets: Tuple[int, ...], P: int,
               w: int) -> LocalPlan:
    """Sort the rank's destinations once.  edt_local: (ns, Emax) local rows
    in [0, P + w) or -1, on the rank's device.  Entries are in the (i, j, e)
    order of Ke, each going to d * (P + w) + row."""
    D, ext = len(offsets), P + w
    edt = edt_local.long()
    table = torch.tensor(offsets, dtype=torch.int64, device=edt.device)
    rows, cols = edt[:, None, :], edt[None, :, :]
    d = torch.searchsorted(table, cols - rows)
    dest = torch.where((rows >= 0) & (cols >= 0), d * ext + rows, D * ext)
    rdest = torch.where(edt >= 0, edt, ext)
    return LocalPlan(mat=Segments.from_dest(dest.reshape(-1), D * ext + 1),
                     rhs=Segments.from_dest(rdest.reshape(-1), ext + 1),
                     n_diag=D, P=P, w=w)


def _send_spill(spill: torch.Tensor, own_head: torch.Tensor) -> None:
    """Send `spill` to the right neighbour and add what the left one sends
    into `own_head` (in place): the ring shift of the stash exchange."""
    rank, size = dist.get_rank(), dist.get_world_size()
    ops, recv = [], None
    if rank > 0:
        recv = torch.empty_like(own_head)
        ops.append(dist.P2POp(dist.irecv, recv, rank - 1))
    if rank < size - 1:
        ops.append(dist.P2POp(dist.isend, spill.contiguous(), rank + 1))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if recv is not None:
        own_head.add_(recv)


def assemble_dia_local(Ke: torch.Tensor, Fe: torch.Tensor,
                       plan: LocalPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-rank DIA assembly and the ghost reduction: Ke (ns, ns, Emax),
    Fe (ns, Emax) -> (vals_own (D, P), b_own (P,)) of this rank."""
    P, w = plan.P, plan.w
    vals_ext = plan.mat.sum(Ke).reshape(plan.n_diag, P + w)
    b_ext = plan.rhs.sum(Fe)
    vals_own = vals_ext[:, :P].contiguous()
    b_own = b_ext[:P].contiguous()
    # spill [P, P+w) belongs to the right neighbour's rows [0, w)
    _send_spill(vals_ext[:, P:], vals_own[:, :w])
    _send_spill(b_ext[P:], b_own[:w])
    return vals_own, b_own
