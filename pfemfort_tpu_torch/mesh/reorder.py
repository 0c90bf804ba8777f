# Copied from pfemfort_tpu/mesh/reorder.py.
"""Geometric structure recovery: lexicographic node renumbering.

SpMV throughput is set by the sparsity STRUCTURE: a small diagonal census
unlocks the gather-free DIA kernel (sparse/dia_spmv_cuda.py) while an
arbitrary numbering forces the gather-based ELL path.  The numbering is
ours to choose — the reference renumbers for partition contiguity
(triapoissonparallelimpl1.F:549-700); we additionally renumber for
STRUCTURE: sorting nodes lexicographically by (z, y, x) coordinate exactly
restores the generator lattice order for any permutation of a structured
mesh, and tightens the band for general meshes.

Used by drivers/common.py:solve_implicit when a structure-less mesh's
offset census fails the DIA threshold.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pfemfort_tpu_torch.mesh.core import Mesh


def geometric_node_order(coords: np.ndarray, decimals: int = 9) -> np.ndarray:
    """Node permutation (old -> new) sorting by (z, y, x), x fastest.

    Coordinates are rounded to `decimals` so lattice planes with fp noise
    still collate.  Stable, deterministic.
    """
    keys = tuple(np.round(coords[:, d], decimals)
                 for d in range(coords.shape[1]))
    order = np.lexsort(keys)           # last key (z) is primary
    perm = np.empty(len(order), dtype=np.int64)
    perm[order] = np.arange(len(order))
    return perm


def apply_node_perm(mesh: Mesh, perm: np.ndarray,
                    dirichlet: Optional[np.ndarray] = None,
                    force_bc: Optional[np.ndarray] = None):
    """Renumber the mesh and remap (node, dof, value) BC tables."""
    mesh2 = mesh.renumbered(perm)

    def remap(arr):
        if arr is None or len(arr) == 0:
            return arr
        out = np.array(arr, dtype=np.float64, copy=True)
        out[:, 0] = perm[out[:, 0].astype(np.int64)]
        return out

    return mesh2, remap(dirichlet), remap(force_bc)


def recover_structure(mesh: Mesh, ndof: int, dirichlet: np.ndarray,
                      force_bc: Optional[np.ndarray] = None,
                      max_offsets: int = 128):
    """Try to restore a DIA-qualifying numbering for a structure-less mesh.

    Returns (mesh2, dbc2, fbc2, perm, dofmap_orig) when the renumbered
    census fits `max_offsets` diagonals, else None.  Cost: two O(nnz)
    censuses + one sort — negligible next to a solve.
    """
    from pfemfort_tpu_torch.assembly.pattern import _offset_census
    from pfemfort_tpu_torch.dofs.dofmap import build_dofmap

    if mesh.structure is not None:
        return None
    dofmap = build_dofmap(mesh, ndof, dirichlet)
    uniq0 = _offset_census(dofmap.elem_dof, dofmap.total_dof)
    if len(uniq0) <= max_offsets:
        return None                    # already DIA-able as numbered
    perm = geometric_node_order(mesh.coords)
    if np.array_equal(perm, np.arange(mesh.n_node)):
        return None
    mesh2, dbc2, fbc2 = apply_node_perm(mesh, perm, dirichlet, force_bc)
    dofmap2 = build_dofmap(mesh2, ndof, dbc2)
    uniq2 = _offset_census(dofmap2.elem_dof, dofmap2.total_dof)
    if len(uniq2) > max_offsets:
        return None                    # genuinely unstructured: keep ELL
    return mesh2, dbc2, fbc2, perm, dofmap
