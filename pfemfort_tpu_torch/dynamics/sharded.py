# Ported from pfemfort_tpu/dynamics/sharded.py (per rank: the shard_map body becomes each rank's loop).
"""Multi-rank explicit dynamics: slab-sharded central differences.

The reference's explicit drivers are effectively single-rank (their element
ownership check is commented out and the rhs is never reduced across
ranks, triaelasticityexplicit.F:998,1056; SURVEY §3.3).  This module does
what the reference intended, one process per rank:
  * nodes are slab-partitioned along the longest axis and renumbered
    rank-contiguously; each rank owns the elements whose lowest node part
    is its own (an element spans at most two neighbouring slabs);
  * each step: the displacement halos from both ring neighbours (one batch
    of point-to-point pairs), the batched element residual on the rank's
    elements, the same fixed-order gather-sum as the single-device loop
    (assembly/assemble.py:Segments: no atomics, so float32 repeats bit for
    bit), and the halo sums sent back and added to the neighbours' rows
    (the PETSc VecAssembly ghost-add, two more pairs); on the card the
    residual is kernel B3's element pass and the sums take its node pass's
    order (dynamics/explicit_cuda.py), as the single-device loop's do;
  * the time loop is a host loop whose state stays on the rank's device;
    the probes are recorded per step on the rank that owns them and
    summed over the ranks ONCE at the end (zeros plus the one owner's
    value: the bits of the JAX package's per-step psum).

Every rank of the default process group (parallel/multihost.py) calls
`explicit_dynamics_sharded` together.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pfemfort_tpu_torch.assembly.assemble import Segments
from pfemfort_tpu_torch.dofs.dofmap import build_dofmap
from pfemfort_tpu_torch.dynamics.explicit import _MASS_NGP, ExplicitResult
from pfemfort_tpu_torch.dynamics.explicit_cuda import ElementPass, \
    node_plan, ordered_summer
from pfemfort_tpu_torch.elements.elasticity import apply_residual, dmat_3d, \
    dmat_plane_strain, lumped_mass, residual_geometry
from pfemfort_tpu_torch.elements.geometry import rank_element_coords
from pfemfort_tpu_torch.mesh.core import Mesh
from pfemfort_tpu_torch.parallel.dist_ell import _exchange
from pfemfort_tpu_torch.parallel.partition import slab_partition
from pfemfort_tpu_torch.parallel.shard_cg import _gathered
from pfemfort_tpu_torch.sparse.formats import round_up
from pfemfort_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class ShardedExplicitSetup:
    """One rank's block of the slab-sharded explicit system (the JAX
    package's per-shard arrays at index `rank`)."""
    n_shards: int
    rank: int
    rows_per_shard: int        # P (node-dofs per rank, padded)
    halo: int                  # W (node-dofs), halo width each side
    node_perm: np.ndarray      # old node -> new (padded) node id
    coords: np.ndarray         # (npe, ndim, Emax) float64
    gather: np.ndarray         # (ns, Emax) int64 ids into [left|own|right]
    wmask: np.ndarray          # (Emax,) 1.0 real / 0.0 padding element
    free: np.ndarray           # (P,) bool free-dof mask
    probe_owner: np.ndarray    # (n_probe,) owning rank
    probe_local: np.ndarray    # (n_probe,) row within the owner


def build_sharded_explicit(mesh: Mesh, ndof: int, dirichlet: np.ndarray,
                           n_shards: int, rank: int,
                           probe_dofs: Sequence[int] = (),
                           lane_pad: int = 8) -> ShardedExplicitSetup:
    """Rank `rank`'s block (host arrays).  Raises ValueError when an
    element spans more than two slabs or a halo is wider than a rank."""
    dofmap = build_dofmap(mesh, ndof, dirichlet)
    # slab partition of NODES along the longest axis, contiguous renumber
    node_part = slab_partition(mesh.coords, n_shards)
    order = np.argsort(node_part, kind="stable")
    counts = np.bincount(node_part, minlength=n_shards)
    Pn = round_up(int(counts.max()), lane_pad)
    # new padded node id: rank*Pn + position within the rank
    within = np.zeros(mesh.n_node, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for s in range(n_shards):
        within[order[starts[s]:starts[s + 1]]] = np.arange(counts[s])
    node_new = node_part.astype(np.int64) * Pn + within
    Prow = Pn * ndof

    # element ownership = lowest node part (elements span slabs s..s+1)
    conn_new = node_new[mesh.conn]
    elem_part = node_part[mesh.conn].min(axis=1).astype(np.int64)
    if (node_part[mesh.conn].max(axis=1) - elem_part).max(initial=0) > 1:
        raise ValueError("an element spans more than two slabs; "
                         "use fewer shards or a finer mesh")
    Emax = int(np.bincount(elem_part, minlength=n_shards).max())
    ns = mesh.npe * ndof

    # halo width in node-dofs: the farthest node past an owner's own block
    rel = conn_new - (elem_part * Pn)[:, None]
    halo_nodes = int(np.maximum(rel - Pn + 1, 0).max(initial=0))
    W = round_up(max(halo_nodes, 1), lane_pad) * ndof
    if W > Prow:
        raise ValueError(f"halo {W} exceeds the {Prow} rows of a rank")

    els = np.nonzero(elem_part == rank)[0]
    k = len(els)
    # padding elements: element 0's geometry, slot 0, weight 0
    coords = rank_element_coords(mesh, els, Emax)
    gather = np.zeros((ns, Emax), dtype=np.int64)
    wmask = np.zeros(Emax)
    # extended index of a node-dof: (node_new - rank*Pn)*ndof + d + W
    loc = (conn_new[els] - rank * Pn) * ndof
    gather[:, :k] = ((loc[:, :, None] + np.arange(ndof)[None, None, :])
                     .reshape(k, ns) + W).T
    wmask[:k] = 1.0

    free = np.zeros(Prow, dtype=bool)
    own = np.nonzero(node_part == rank)[0]
    free.reshape(Pn, ndof)[within[own]] = \
        dofmap.free_mask_full().reshape(mesh.n_node, ndof)[own]

    probe = np.asarray(probe_dofs, dtype=np.int64)
    pnew = node_new[probe // ndof]
    return ShardedExplicitSetup(
        n_shards=n_shards, rank=rank, rows_per_shard=Prow, halo=W,
        node_perm=node_new, coords=coords, gather=gather, wmask=wmask,
        free=free, probe_owner=(pnew // Pn).astype(np.int32),
        probe_local=((pnew % Pn) * ndof + probe % ndof).astype(np.int32))


def _ring(W: int) -> Tuple[Callable, Callable]:
    """(ring_halo, ring_add) of this rank: the neighbours' boundary values
    around the rank's own rows, and the halo sums added back into the
    neighbours' rows."""
    rank, size = dist.get_rank(), dist.get_world_size()
    has_l, has_r = rank > 0, rank < size - 1

    def ring_halo(v_own):
        left, right = v_own.new_zeros(W), v_own.new_zeros(W)
        _exchange(([(rank + 1, v_own[-W:])] if has_r else [])
                  + ([(rank - 1, v_own[:W])] if has_l else []),
                  ([(rank - 1, left)] if has_l else [])
                  + ([(rank + 1, right)] if has_r else []))
        return torch.cat([left, v_own, right])

    def ring_add(v_ext):
        from_left, from_right = v_ext.new_empty(W), v_ext.new_empty(W)
        _exchange(([(rank - 1, v_ext[:W])] if has_l else [])
                  + ([(rank + 1, v_ext[-W:])] if has_r else []),
                  ([(rank + 1, from_right)] if has_r else [])
                  + ([(rank - 1, from_left)] if has_l else []))
        own = v_ext[W:-W].clone()
        if has_r:
            own[-W:] += from_right
        if has_l:
            own[:W] += from_left
        return own

    return ring_halo, ring_add


def explicit_dynamics_sharded(
    mesh: Mesh,
    dirichlet: np.ndarray,
    E: float,
    nu: float,
    dens: float,
    dt: float,
    nsteps: int,
    bforce_fn: Optional[Callable] = None,
    probe_dofs: Sequence[int] = (),
    thickness: float = 1.0,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
) -> ExplicitResult:
    """Slab-sharded central-difference dynamics over the default process
    group, on `device` (each rank's card under NCCL, the CPU under gloo).
    The arguments are explicit_dynamics's; bforce_fn takes t as a 0-d
    tensor of the working dtype on the device.  Returns the whole
    ExplicitResult on every rank."""
    device = resolve_device(device)
    if dtype is None:
        dtype = torch.get_default_dtype()
    rank, size = dist.get_rank(), dist.get_world_size()
    ndim = mesh.ndim
    ndof = ndim
    setup = build_sharded_explicit(mesh, ndof, dirichlet, size, rank,
                                   probe_dofs)
    P, W = setup.rows_per_shard, setup.halo
    ext = P + 2 * W
    D = dmat_plane_strain(E, nu) if ndim == 2 else dmat_3d(E, nu)
    as_dev = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    if bforce_fn is None:
        zero_b = torch.zeros(ndim, dtype=dtype, device=device)
        bforce_fn = lambda t: zero_b

    free = torch.as_tensor(setup.free, device=device)
    ring_halo, ring_add = _ring(W)
    thick = thickness if ndim == 2 else 1.0
    if device.type == "cuda":
        # kernel B3's element pass on the rank's own elements, summed in
        # its node pass's order: at world size 1 the single-device loop's
        # bits
        k = int(setup.wmask.sum())
        coords_em = as_dev(setup.coords[:, :, :k])
        gid = torch.as_tensor(setup.gather[:, :k], device=device)
        plan = node_plan(Segments.from_dest(gid.reshape(-1), ext + 1), k,
                         mesh.npe, ndof, ext // ndof)
        element = ElementPass(coords_em, setup.gather[::ndof, :k].T // ndof,
                              mesh.etype, D, dens, thick, bforce_fn, ext)
        mass_em = lumped_mass(coords_em, mesh.etype, dens, ndof,
                              ngp=_MASS_NGP[mesh.etype])
        summed = ordered_summer(plan, ndof)
        M = ring_add(summed(mass_em.T.contiguous().reshape(-1)))

        def residual(disp_own, t):
            return ring_add(summed(element(ring_halo(disp_own), t)))
    else:
        coords_em = as_dev(setup.coords)
        gid = torch.as_tensor(setup.gather, device=device)
        seg = Segments.from_dest(gid.reshape(-1), ext + 1)
        wm = as_dev(setup.wmask)
        M = ring_add(seg.sum(lumped_mass(coords_em, mesh.etype, dens, ndof,
                                         ngp=_MASS_NGP[mesh.etype])
                             * wm[None, :]))
        geom = residual_geometry(coords_em, mesh.etype, thickness=thick)

        def residual(disp_own, t):
            disp_em = ring_halo(disp_own)[gid]              # (ns, Emax)
            Fe = apply_residual(geom, disp_em, D, dens, bforce_fn(t))
            return ring_add(seg.sum(Fe * wm[None, :]))
    has_mass = M > 0
    upd = torch.logical_and(free, has_mass)
    Msafe = torch.where(has_mass, M, 1.0)

    dtt, idtt, two_dt = as_dev(dt * dt), as_dev(1.0 / (dt * dt)), \
        as_dev(2.0 * dt)
    mine = torch.as_tensor(setup.probe_owner == rank, device=device)
    ploc = torch.as_tensor(setup.probe_local.astype(np.int64), device=device)
    n_probe = ploc.numel()
    hist = torch.zeros((nsteps, 2 * n_probe), dtype=dtype, device=device)
    t_all = torch.arange(nsteps, device=device).to(dtype) * as_dev(dt)

    disp = torch.zeros(P, dtype=dtype, device=device)
    disp_prev, velo, acce = disp.clone(), disp.clone(), disp.clone()
    for k in range(nsteps):
        rhs = residual(disp, t_all[k])
        rhs = rhs + idtt * M * (2.0 * disp - disp_prev)
        new = torch.where(upd, dtt * rhs / Msafe, 0.0)
        velo = (new - disp_prev) / two_dt
        if k == nsteps - 1:
            acce = (new - 2.0 * disp + disp_prev) * idtt
        disp_prev, disp = disp, new
        if n_probe:
            hist[k, :n_probe] = torch.where(mine, disp[ploc], 0.0)
            hist[k, n_probe:] = torch.where(mine, velo[ploc], 0.0)
    if size > 1:
        dist.all_reduce(hist)

    # every rank's rows, back in the caller's node numbering
    idx = (setup.node_perm[:, None] * ndof
           + np.arange(ndof)[None, :]).reshape(-1)
    host = lambda v: _gathered(v).cpu().to(torch.float64).numpy()[idx]
    return ExplicitResult(
        disp=host(disp), velo=host(velo), acce=host(acce),
        probe_history=hist.cpu().numpy(),
        times=np.arange(nsteps, dtype=np.float64) * dt)
