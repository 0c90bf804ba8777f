"""Mesh kind `box_tet`: the reference generator's tetrahedral box.

Copied arithmetic of PFEMFort's src/genTetra.cpp (the port carries the same
in pfemfort_tpu_torch/mesh/generate.py:box_tet): an nex x ney x nez lattice
of hexahedra, x fastest, then y, then z, each cut into the same six
tetrahedra.  The benchmark makes the arrays itself and hands the same ones
to the port and to the plain reference, so neither side's generator is
measured or trusted.

A configuration's "mesh" is {"kind": "box_tet", "cells": [nex, ney, nez],
"box": [[x0, x1], [y0, y1], [z0, z1]]}; its "dirichlet" {"faces": ...} is
'all' (genTetra's Dirichlet set) or 'x0' (the face x = x0, a clamped end).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

# Corner ids (bit 0: +x, bit 1: +y, bit 2: +z) of the six tetrahedra of
# one hexahedron, in genTetra's order.
TET_SPLIT = np.array([[0, 1, 3, 5], [0, 3, 2, 5], [2, 3, 7, 5],
                      [4, 6, 7, 2], [4, 7, 5, 2], [0, 4, 5, 2]],
                     dtype=np.int32)
WARM_CELLS = 8    # cells a side of the warm-up's box


class MeshArrays(NamedTuple):
    coords: np.ndarray          # (n_node, 3) float64
    conn: np.ndarray            # (n_elem, 4) int32, 0-based
    etype: str
    structure: Optional[dict]   # the generator's tag, as the port's Mesh has


def build(spec: dict) -> MeshArrays:
    """The tetrahedral box of spec["cells"] hexahedra over spec["box"]."""
    nex, ney, nez = (int(c) for c in spec["cells"])
    (x0, x1), (y0, y1), (z0, z1) = spec["box"]
    xs = np.linspace(x0, x1, nex + 1)
    ys = np.linspace(y0, y1, ney + 1)
    zs = np.linspace(z0, z1, nez + 1)
    Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    nnx, nny = nex + 1, ney + 1
    base = (np.arange(nez, dtype=np.int32)[:, None, None] * (nnx * nny)
            + np.arange(ney, dtype=np.int32)[None, :, None] * nnx
            + np.arange(nex, dtype=np.int32)[None, None, :])
    corner = np.array([0, 1, nnx, nnx + 1, nnx * nny, nnx * nny + 1,
                       nnx * nny + nnx, nnx * nny + nnx + 1], dtype=np.int32)
    conn = np.empty((nez, ney, nex, 6, 4), dtype=np.int32)
    for c in range(6):
        for i in range(4):
            conn[:, :, :, c, i] = base + corner[TET_SPLIT[c, i]]
    return MeshArrays(coords, conn.reshape(-1, 4), "tetra4",
                      dict(kind="box_tet", nex=nex, ney=ney, nez=nez))


def small(spec: dict) -> dict:
    """A box of the same kind and extent, WARM_CELLS a side: the warm-up's
    mesh."""
    return dict(spec, cells=[WARM_CELLS] * 3)


def counts(spec: dict, faces: str) -> dict:
    """Elements, nodes and Dirichlet nodes of the box, from its sizes."""
    nex, ney, nez = (int(c) for c in spec["cells"])
    nodes = (nex + 1) * (ney + 1) * (nez + 1)
    interior = {"all": (nex - 1) * (ney - 1) * (nez - 1),
                "x0": nex * (ney + 1) * (nez + 1)}[faces]
    return dict(elements=6 * nex * ney * nez, nodes=nodes,
                dirichlet_nodes=nodes - interior)


def boundary_nodes(mesh: MeshArrays, faces: str) -> np.ndarray:
    """Node ids on the box's faces: 'all' or 'x0'."""
    s = mesh.structure
    nex, ney, nez = s["nex"], s["ney"], s["nez"]
    on = np.zeros((nez + 1, ney + 1, nex + 1), dtype=bool)
    if faces == "all":
        on[0], on[-1] = True, True
        on[:, 0], on[:, -1] = True, True
        on[:, :, 0], on[:, :, -1] = True, True
    elif faces == "x0":
        on[:, :, 0] = True
    else:
        raise ValueError(f"faces={faces!r}: 'all' or 'x0'")
    return np.nonzero(on.reshape(-1))[0]
