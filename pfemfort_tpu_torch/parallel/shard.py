# Copied from pfemfort_tpu/parallel/shard.py.
"""Row-sharded system construction: partition -> contiguous renumbering ->
a shard-ordered assembly pattern (host-side numpy, the same arrays as the
JAX package's).

The port's counterpart of the reference's partition-contiguous row
renumbering (node_start/node_end/row_start/row_end,
PFEMFort src/triapoissonparallelimpl1.F:536-700): free equations are
reordered so rank s owns rows [s*P, (s+1)*P) with P identical across ranks
(padded with empty rows, so every rank's block has one shape).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pfemfort_tpu_torch.assembly.pattern import AssemblyPattern, \
    build_pattern
from pfemfort_tpu_torch.dofs.dofmap import DofMap, build_dofmap, \
    reduced_lattice
from pfemfort_tpu_torch.mesh.core import Mesh
from pfemfort_tpu_torch.parallel.partition import nodes_from_elem_partition, \
    partition_elements
from pfemfort_tpu_torch.sparse.formats import round_up


@dataclasses.dataclass
class ShardedSystem:
    n_shards: int
    rows_per_shard: int           # P
    n_rows_padded: int            # n_shards * P
    dofmap: DofMap                # original (unpermuted) dofmap
    pattern: AssemblyPattern      # pattern over padded, shard-ordered rows
    eq_perm: np.ndarray           # (total_dof,) old eq id -> padded row id
    elem_part: np.ndarray         # (n_elem,) partition of each element
    node_part: np.ndarray         # (n_node,)

    def reduce_solution(self, x_padded: np.ndarray) -> np.ndarray:
        """Padded shard-ordered vector -> original eq ordering."""
        return np.asarray(x_padded)[self.eq_perm]

    def expand_rhs(self, b_orig: np.ndarray) -> np.ndarray:
        out = np.zeros(self.n_rows_padded, dtype=b_orig.dtype)
        out[self.eq_perm] = b_orig
        return out


def _within_shard_order(mesh: Mesh, node_part: np.ndarray,
                        n_shards: int) -> np.ndarray:
    """Per-shard geometric (z, y, x)-lexicographic rank of every node: a
    bandwidth-reduced local numbering, which recovers the lattice numbering
    exactly on near-lattice meshes."""
    keys = [mesh.coords[:, d] for d in range(mesh.ndim)]
    order = np.lexsort(tuple(keys) + (node_part,))
    part_sorted = node_part[order]
    first = np.ones(len(order), dtype=bool)
    first[1:] = part_sorted[1:] != part_sorted[:-1]
    start_of = np.zeros(len(order), dtype=np.int64)
    start_of[first] = np.nonzero(first)[0]
    np.maximum.accumulate(start_of, out=start_of)
    rank = np.empty(mesh.n_node, dtype=np.int64)
    rank[order] = np.arange(len(order)) - start_of
    return rank


def build_sharded_system(
    mesh: Mesh,
    ndof: int,
    dirichlet: np.ndarray,
    n_shards: int,
    method: str = "rcb",
    lane_pad: int = 8,
    layout: str = "auto",
) -> ShardedSystem:
    """Partition the mesh and build a shard-contiguous assembly pattern.

    method 'slab': rank s owns rows [s*P, (s+1)*P) of the ORIGINAL equation
    numbering (eq_perm = identity, padding only past the end), the literal
    row_start/row_end ownership, which keeps the lattice numbering and so
    the DIA offset census; on a reduced lattice P is rounded up to whole
    lattice planes, and the padded row space is itself a lattice.
    'rcb'/'greedy': partition the elements, give each free equation its
    node's part and order each part's nodes geometrically; for ndof > 1
    the rows are node-aligned (each node with a free dof owns ndof
    consecutive slots), so rows r // ndof are true node blocks.
    """
    dofmap = build_dofmap(mesh, ndof, dirichlet)
    red_lat = None
    if method == "slab":
        P = round_up(-(-max(dofmap.total_dof, 1) // n_shards), lane_pad)
        red_lat = reduced_lattice(mesh, dofmap)
        if red_lat is not None and len(red_lat) >= 2:
            plane = int(np.prod(red_lat[1:]))
            P = plane * (-(-P // plane))
        eq_perm = np.arange(dofmap.total_dof, dtype=np.int64)
        eq_node = dofmap.assy_for_soln // ndof
        node_part = np.zeros(mesh.n_node, dtype=np.int32)
        node_part[eq_node] = np.minimum(eq_perm // P, n_shards - 1)
        elem_part = node_part[mesh.conn].min(axis=1).astype(np.int32)
    else:
        elem_part = partition_elements(mesh, n_shards, method=method)
        node_part = nodes_from_elem_partition(mesh, elem_part,
                                              max(n_shards, 1))
        eq_node = dofmap.assy_for_soln // ndof      # (total_dof,)
        eq_part = node_part[eq_node]
        node_rank = _within_shard_order(mesh, node_part, n_shards)

        if ndof > 1:
            eq_comp = dofmap.assy_for_soln % ndof
            has_free = np.zeros(mesh.n_node, dtype=bool)
            has_free[eq_node] = True
            nodes_idx = np.nonzero(has_free)[0]
            npart = node_part[nodes_idx].astype(np.int64)
            order_n = np.lexsort((nodes_idx, node_rank[nodes_idx], npart))
            node_slot = np.full(mesh.n_node, -1, dtype=np.int64)
            countsn = np.bincount(npart, minlength=n_shards)
            startn = 0
            for s in range(n_shards):
                c = countsn[s]
                node_slot[nodes_idx[order_n[startn:startn + c]]] = \
                    np.arange(c)
                startn += c
            # P a multiple of lane_pad AND ndof so (P//ndof, ndof) reshapes
            P = round_up(max(int(countsn.max(initial=1)), 1) * ndof,
                         lane_pad * ndof)
            eq_perm = (eq_part.astype(np.int64) * P
                       + node_slot[eq_node] * ndof + eq_comp)
        else:
            counts = np.bincount(eq_part, minlength=n_shards)
            P = round_up(max(int(counts.max(initial=1)), 1), lane_pad)
            order = np.lexsort((np.arange(dofmap.total_dof),
                                node_rank[eq_node], eq_part))
            within = np.zeros(dofmap.total_dof, dtype=np.int64)
            start = 0
            for s in range(n_shards):
                c = counts[s]
                within[order[start:start + c]] = np.arange(c)
                start += c
            eq_perm = (eq_part.astype(np.int64) * P + within).astype(
                np.int64)

    # Remap elem_dof into padded row space (-1 sentinels preserved).
    elem_dof = dofmap.elem_dof
    mapped = np.where(elem_dof >= 0, eq_perm[np.clip(elem_dof, 0, None)], -1)

    pad_lat = None
    if red_lat is not None and len(red_lat) >= 2:
        plane = int(np.prod(red_lat[1:]))
        if (n_shards * P) % plane == 0:
            pad_lat = ((n_shards * P) // plane,) + tuple(red_lat[1:])

    pattern = build_pattern(mapped.astype(np.int32), n_shards * P,
                            lane_pad=lane_pad, layout=layout,
                            lattice=pad_lat)
    return ShardedSystem(
        n_shards=n_shards,
        rows_per_shard=P,
        n_rows_padded=n_shards * P,
        dofmap=dofmap,
        pattern=pattern,
        eq_perm=eq_perm,
        elem_part=elem_part,
        node_part=node_part,
    )
