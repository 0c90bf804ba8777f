# Copied from pfemfort_tpu/parallel/partition.py (RCB and greedy always on the host library).
"""Mesh partitioning: coordinate RCB and greedy graph k-way.

METIS-free replacements for the reference's partitioning layer
(METIS_PartMeshDual/Nodal in-driver, PFEMFort src/
triapoissonparallelimpl1.F:488-491; standalone partitioners §2.3 of SURVEY).
RCB is near-optimal for the generated box meshes used in all benchmarks; the
greedy BFS k-way handles genuinely unstructured inputs.
`partition_elements` runs both through the host library
(csrc/host_native.cpp, the JAX package's C++ copied unchanged), so its
partitions equal the JAX package's with its native library built; the
numpy/Python versions below are kept as the readable references.
"""

from __future__ import annotations

import numpy as np

from pfemfort_tpu_torch import host_native
from pfemfort_tpu_torch.mesh.core import Mesh

# Shared nodes that make two elements dual-graph neighbours (the reference
# partitioner's table, meshpartitionfortparmetis.cpp:139-158).
NCOMMON = {"tria3": 2, "tria6": 2, "quad4": 2, "tetra4": 3, "prism6": 3,
           "hexa8": 4}


def rcb_partition(centroids: np.ndarray, n_parts: int) -> np.ndarray:
    """Recursive coordinate bisection into n_parts balanced parts.

    Splits along the longest axis at the weighted median; supports any
    n_parts (not just powers of two) by unbalanced splits proportional to
    the part counts.
    """
    n = centroids.shape[0]
    part = np.zeros(n, dtype=np.int32)

    def rec(idx: np.ndarray, k: int, first: int):
        if k == 1:
            part[idx] = first
            return
        k_left = k // 2
        frac = k_left / k
        pts = centroids[idx]
        axis = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
        order = np.argsort(pts[:, axis], kind="stable")
        n_left = int(round(frac * len(idx)))
        rec(idx[order[:n_left]], k_left, first)
        rec(idx[order[n_left:]], k - k_left, first + k_left)

    rec(np.arange(n, dtype=np.int64), n_parts, 0)
    return part


def dual_graph(mesh: Mesh, ncommon: int | None = None):
    """Element dual graph: elements adjacent iff they share >= ncommon nodes.

    Same ncommon table as the reference partitioner (tria 2, quad 2, tet 3,
    hex 4; PFEMFort src/meshpartitionfortparmetis.cpp:139-158).
    Returns CSR (indptr, adj).
    """
    if ncommon is None:
        ncommon = NCOMMON[mesh.etype]
    indptr_ne, elem_ids = mesh.node_elem_adjacency()
    E, npe = mesh.n_elem, mesh.npe
    # Pair counting: for each node, all element pairs sharing it.
    pair_counts = {}
    from collections import defaultdict
    counts = defaultdict(int)
    for node in range(mesh.n_node):
        es = elem_ids[indptr_ne[node]:indptr_ne[node + 1]]
        for a in range(len(es)):
            for b in range(a + 1, len(es)):
                e1, e2 = int(es[a]), int(es[b])
                if e1 > e2:
                    e1, e2 = e2, e1
                counts[(e1, e2)] += 1
    adj = [[] for _ in range(E)]
    for (e1, e2), c in counts.items():
        if c >= ncommon:
            adj[e1].append(e2)
            adj[e2].append(e1)
    indptr = np.zeros(E + 1, dtype=np.int64)
    flat = []
    for e in range(E):
        adj[e].sort()
        flat.extend(adj[e])
        indptr[e + 1] = len(flat)
    return indptr, np.asarray(flat, dtype=np.int32)


def greedy_graph_partition(indptr: np.ndarray, adj: np.ndarray,
                           n_parts: int) -> np.ndarray:
    """Greedy BFS growth k-way partition of a CSR graph (METIS stand-in)."""
    n = len(indptr) - 1
    target = (n + n_parts - 1) // n_parts
    part = np.full(n, -1, dtype=np.int32)
    from collections import deque
    seed_scan = 0
    for p in range(n_parts):
        frontier = deque()
        size = 0
        # Reseed when the frontier dries up so parts stay balanced even
        # across disconnected pockets.
        while size < target:
            if not frontier:
                while seed_scan < n and part[seed_scan] != -1:
                    seed_scan += 1
                if seed_scan >= n:
                    break
                frontier.append(seed_scan)
            e = frontier.popleft()
            if part[e] != -1:
                continue
            part[e] = p
            size += 1
            for nb in adj[indptr[e]:indptr[e + 1]]:
                if part[nb] == -1:
                    frontier.append(int(nb))
    # any stragglers -> last part
    part[part == -1] = n_parts - 1
    return part


def slab_partition(centroids: np.ndarray, n_parts: int,
                   axis: int | None = None) -> np.ndarray:
    """1D slab decomposition along one axis (default: the longest).

    The direct analog of the reference's contiguous row-block ownership
    (node_start/node_end, triapoissonparallelimpl1.F:536-544): parts are
    geometric slabs in ascending coordinate order, so shard k's halo touches
    only shards k-1 and k+1 — the precondition for the ring ppermute
    exchange in parallel/halo.py.
    """
    if axis is None:
        axis = int(np.argmax(centroids.max(axis=0) - centroids.min(axis=0)))
    order = np.argsort(centroids[:, axis], kind="stable")
    n = centroids.shape[0]
    part = np.zeros(n, dtype=np.int32)
    bounds = (np.arange(1, n_parts) * n) // n_parts
    part[order] = np.searchsorted(bounds, np.arange(n), side="right")
    return part


def partition_elements(mesh: Mesh, n_parts: int,
                       method: str = "rcb") -> np.ndarray:
    if n_parts <= 1:
        return np.zeros(mesh.n_elem, dtype=np.int32)
    if method == "slab":
        return slab_partition(mesh.elem_centroids(), n_parts)
    if method == "rcb":
        return host_native.rcb_partition(mesh.elem_centroids(), n_parts)
    return host_native.greedy_partition(mesh.conn, mesh.n_node,
                                        NCOMMON[mesh.etype], n_parts)


def edge_cut(mesh: Mesh, part: np.ndarray) -> int:
    """Dual-graph edges cut by an element partition (METIS's objval)."""
    return host_native.edge_cut(mesh.conn, mesh.n_node, NCOMMON[mesh.etype],
                                part)


def nodes_from_elem_partition(mesh: Mesh, elem_part: np.ndarray,
                              n_parts: int) -> np.ndarray:
    """Assign each node to the most frequent part among its elements
    (ties -> lowest part id), the analog of METIS's node partition."""
    votes = np.zeros((mesh.n_node, n_parts), dtype=np.int64)
    ep = np.repeat(elem_part, mesh.npe)
    np.add.at(votes, (mesh.conn.ravel(), ep), 1)
    return votes.argmax(axis=1).astype(np.int32)
