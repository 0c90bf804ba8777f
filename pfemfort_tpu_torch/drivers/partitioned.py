# Ported from pfemfort_tpu/drivers/partitioned.py.
"""Pre-partitioned per-rank input mode (triapoissonparallelimpl2 parity).

The reference's impl2 variant has each MPI rank read ONLY its subdomain
files and recover global sizes with MPI_Allreduce
(PFEMFort src/triapoissonparallelimpl2.F:188-231).  Here every rank reads
`<prefix>-p<rank>-*.dat` (mesh/io.py:write_partitioned); the pieces are
merged, locally when one process reads them all, or after a ragged
all_gather over the default process group in a multi-rank run (sizes
first, then the padded arrays), and the merged mesh feeds the distributed
solve (drivers/sharded.py).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pfemfort_tpu_torch.mesh.core import Mesh
from pfemfort_tpu_torch.mesh.io import read_partitioned
from pfemfort_tpu_torch.parallel.multihost import world


def merge_partitions(pieces: Sequence[Tuple[Mesh, Optional[np.ndarray],
                                            np.ndarray]]):
    """Merge (mesh_local, dirichlet_local, node_gids) pieces -> global
    (mesh, dirichlet).  Elements are rank-disjoint by construction
    (write_partitioned); shared boundary nodes deduplicate by global id."""
    etype = pieces[0][0].etype
    ndim = pieces[0][0].ndim
    n_node = int(max(p[2].max() for p in pieces)) + 1
    coords = np.zeros((n_node, ndim), dtype=np.float64)
    seen = np.zeros(n_node, dtype=bool)
    conns = []
    dbc_rows = []
    for mesh_l, dbc_l, gids in pieces:
        coords[gids] = mesh_l.coords
        seen[gids] = True
        conns.append(gids[mesh_l.conn])
        if dbc_l is not None and len(dbc_l):
            d = dbc_l.copy()
            d[:, 0] = gids[dbc_l[:, 0].astype(np.int64)]
            dbc_rows.append(d)
    if not seen.all():
        raise ValueError(f"{(~seen).sum()} global nodes missing from the "
                         "rank files")
    conn = np.concatenate(conns, axis=0)
    dbc = None
    if dbc_rows:
        dbc = np.concatenate(dbc_rows, axis=0)
        # shared boundary nodes appear in several rank files: dedup (node,dof)
        _, keep = np.unique(dbc[:, 0] * 8 + dbc[:, 1], return_index=True)
        dbc = dbc[np.sort(keep)]
    return Mesh(etype, coords, conn), dbc


def read_partitioned_local(prefix: str, ranks: Sequence[int]):
    """Single-process form: read the given rank files and merge."""
    return merge_partitions([read_partitioned(prefix, r) for r in ranks])


def _gather_ragged(arr: np.ndarray, device) -> list:
    """Every rank's `arr` (same trailing shape and dtype, any length), in
    rank order: the lengths all_gathered first, then the arrays padded to
    the longest and all_gathered (the reference impl2's Allgatherv)."""
    size = dist.get_world_size()
    a = torch.as_tensor(np.ascontiguousarray(arr), device=device)
    n = torch.tensor([a.shape[0]], dtype=torch.int64, device=device)
    lengths = [torch.empty_like(n) for _ in range(size)]
    dist.all_gather(lengths, n)
    lengths = [int(v) for v in lengths]
    pad = a.new_zeros((max(max(lengths), 1),) + tuple(a.shape[1:]))
    pad[:a.shape[0]] = a
    parts = [torch.empty_like(pad) for _ in range(size)]
    dist.all_gather(parts, pad)
    return [p[:m].cpu().numpy() for p, m in zip(parts, lengths)]


def read_partitioned_multiprocess(prefix: str):
    """Multi-rank form: THIS rank reads only its own files; the pieces are
    exchanged with ragged all_gathers over the default process group (the
    MPI_Allreduce/Allgatherv of the reference impl2), on the group's
    device.  Every rank calls it together."""
    rank, device = dist.get_rank(), world().device
    mesh_l, dbc_l, gids = read_partitioned(prefix, rank)
    dbc_arr = dbc_l if dbc_l is not None else np.zeros((0, 3))
    coords_all, conn_all, gids_all, dbc_all = (
        _gather_ragged(np.asarray(a, dtype=dt), device)
        for a, dt in ((mesh_l.coords, np.float64), (mesh_l.conn, np.int64),
                      (gids, np.int64), (dbc_arr, np.float64)))
    pieces = []
    for p in range(len(coords_all)):
        m = Mesh(mesh_l.etype, coords_all[p], conn_all[p].astype(np.int32))
        d = dbc_all[p] if len(dbc_all[p]) else None
        pieces.append((m, d, gids_all[p]))
    return merge_partitions(pieces)


def solve_poisson_partitioned(prefix: str, n_ranks: int,
                              multiprocess: bool = False, **kw):
    """End-to-end per-rank-file Poisson solve (impl2 executable parity):
    read the files (every rank reads `n_ranks` of them, or with
    `multiprocess` only its own), then solve_implicit_sharded over the
    default process group with `kw` (device, dtype, rtol, precond, ...).
    Every rank calls it together.  Returns (mesh, ImplicitResult)."""
    from pfemfort_tpu_torch.drivers.sharded import solve_implicit_sharded
    from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices

    if multiprocess:
        mesh, dbc = read_partitioned_multiprocess(prefix)
    else:
        mesh, dbc = read_partitioned_local(prefix, range(n_ranks))
    source = -6.0 if mesh.etype == "tetra4" else 0.0
    return mesh, solve_implicit_sharded(
        mesh, 1, dbc,
        lambda c: poisson_element_matrices(c, mesh.etype, source=source),
        **kw)
