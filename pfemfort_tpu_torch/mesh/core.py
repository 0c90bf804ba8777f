# Copied from pfemfort_tpu/mesh/core.py.
"""Mesh container and element-type metadata.

The reference has no mesh abstraction: every driver PROGRAM re-reads raw
arrays (e.g. /root/reference/src/triapoissonserialimpl1.F:184-295).  Here the
mesh is a single host-side container of numpy arrays (0-based connectivity)
that all device pipelines consume.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

# Element-type registry.
# npe       : nodes per element
# ndim      : physical/parametric dimension
# vtk_type  : legacy-VTK cell type id, matching the reference writer
#             (/root/reference/src/writervtk.F:100-166: tria3=5, tria6=22,
#              quad4=9, tetra4=10, prism6=13, hexa8=12)
ELEMENT_INFO: Dict[str, dict] = {
    "tria3": dict(npe=3, ndim=2, vtk_type=5),
    "tria6": dict(npe=6, ndim=2, vtk_type=22),
    "quad4": dict(npe=4, ndim=2, vtk_type=9),
    "tetra4": dict(npe=4, ndim=3, vtk_type=10),
    "prism6": dict(npe=6, ndim=3, vtk_type=13),
    "hexa8": dict(npe=8, ndim=3, vtk_type=12),
}


def etype_from_shape(ndim: int, npe: int) -> str:
    """Infer element type the way the reference drivers do (file shape only)."""
    for name, info in ELEMENT_INFO.items():
        if info["ndim"] == ndim and info["npe"] == npe:
            return name
    raise ValueError(f"no element type with ndim={ndim}, npe={npe}")


@dataclasses.dataclass
class Mesh:
    """An unstructured FE mesh (host-side, numpy, 0-based connectivity).

    `structure` optionally records that the mesh came from a structured
    generator (e.g. {'kind': 'box_tet', 'nex':.., 'ney':.., 'nez':..}),
    unlocking the slice-add structured assembly fast path.
    """

    etype: str
    coords: np.ndarray  # (n_node, ndim) float64
    conn: np.ndarray    # (n_elem, npe) int32, 0-based
    structure: Optional[dict] = None

    def __post_init__(self):
        info = ELEMENT_INFO[self.etype]
        self.coords = np.ascontiguousarray(self.coords, dtype=np.float64)
        self.conn = np.ascontiguousarray(self.conn, dtype=np.int32)
        assert self.coords.ndim == 2 and self.coords.shape[1] == info["ndim"], (
            f"coords shape {self.coords.shape} vs ndim {info['ndim']}")
        assert self.conn.ndim == 2 and self.conn.shape[1] == info["npe"], (
            f"conn shape {self.conn.shape} vs npe {info['npe']}")

    @property
    def ndim(self) -> int:
        return ELEMENT_INFO[self.etype]["ndim"]

    @property
    def npe(self) -> int:
        return ELEMENT_INFO[self.etype]["npe"]

    @property
    def n_node(self) -> int:
        return self.coords.shape[0]

    @property
    def n_elem(self) -> int:
        return self.conn.shape[0]

    @property
    def vtk_type(self) -> int:
        return ELEMENT_INFO[self.etype]["vtk_type"]

    def elem_coords(self) -> np.ndarray:
        """Gathered per-element nodal coordinates, shape (n_elem, npe, ndim)."""
        return self.coords[self.conn]

    def elem_centroids(self) -> np.ndarray:
        return self.elem_coords().mean(axis=1)

    def node_elem_adjacency(self):
        """CSR (indptr, elem_ids): for every node, the elements touching it."""
        conn = self.conn
        order = np.argsort(conn.ravel(), kind="stable")
        elem_ids = (order // self.npe).astype(np.int32)
        counts = np.bincount(conn.ravel(), minlength=self.n_node)
        indptr = np.zeros(self.n_node + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return indptr, elem_ids

    def renumbered(self, node_perm: np.ndarray) -> "Mesh":
        """Return a mesh with nodes renumbered; node_perm[old] = new."""
        inv = np.empty_like(node_perm)
        inv[node_perm] = np.arange(self.n_node, dtype=node_perm.dtype)
        return Mesh(self.etype, self.coords[inv], node_perm[self.conn])
