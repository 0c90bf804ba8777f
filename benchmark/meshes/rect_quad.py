"""Mesh kind `rect_quad`: a rectangle of bilinear quadrilaterals.

An nex x ney lattice of cells over [x0, x1] x [y0, y1], nodes numbered x
fastest, then y; cell (i, j) is element j * nex + i, its corners counter-
clockwise from the lower left (the reference's quad4 node order, as
pfemfort_tpu_torch/mesh/generate.py:rect_quad lays it out).  The benchmark
makes the arrays itself and hands the same ones to the port and to the
plain reference, so neither side's generator is measured or trusted.

A configuration's "mesh" is {"kind": "rect_quad", "cells": [nex, ney],
"box": [[x0, x1], [y0, y1]]}; its "dirichlet" {"faces": ...} is 'x0' (the
edge x = x0, a clamped end); the loads may name 'x1' (the free end).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

WARM_CELLS = (16, 8)    # the warm-up's rectangle


class MeshArrays(NamedTuple):
    coords: np.ndarray          # (n_node, 2) float64
    conn: np.ndarray            # (n_elem, 4) int32, 0-based
    etype: str
    structure: Optional[dict]   # none: the port's Mesh carries no tag
    cells: Tuple[int, int]


def _cells(spec: dict) -> Tuple[int, int]:
    cells = tuple(int(c) for c in spec["cells"])
    if len(cells) != 2:
        raise ValueError(f"rect_quad takes cells [nex, ney], got {cells}")
    return cells


def build(spec: dict) -> MeshArrays:
    """The rectangle of spec["cells"] quadrilaterals over spec["box"]."""
    nex, ney = _cells(spec)
    (x0, x1), (y0, y1) = spec["box"]
    Y, X = np.meshgrid(np.linspace(y0, y1, ney + 1),
                       np.linspace(x0, x1, nex + 1), indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)
    nnx = nex + 1
    lower_left = (np.arange(ney, dtype=np.int32)[:, None] * nnx
                  + np.arange(nex, dtype=np.int32)[None, :]).reshape(-1)
    conn = np.stack([lower_left, lower_left + 1, lower_left + 1 + nnx,
                     lower_left + nnx], axis=1)
    return MeshArrays(coords, conn, "quad4", None, (nex, ney))


def small(spec: dict) -> dict:
    """A rectangle of the same kind and extent, WARM_CELLS cells: the
    warm-up's mesh."""
    return dict(spec, cells=list(WARM_CELLS))


def counts(spec: dict, faces: str) -> dict:
    """Elements, nodes and Dirichlet nodes of the rectangle, from its
    sizes."""
    nex, ney = _cells(spec)
    if faces not in ("x0", "x1"):
        raise ValueError(f"faces={faces!r}: 'x0' or 'x1'")
    return dict(elements=nex * ney, nodes=(nex + 1) * (ney + 1),
                dirichlet_nodes=ney + 1)


def boundary_nodes(mesh: MeshArrays, faces: str) -> np.ndarray:
    """Node ids on an end of the rectangle, y ascending: 'x0' or 'x1'."""
    nex, ney = mesh.cells
    if faces not in ("x0", "x1"):
        raise ValueError(f"faces={faces!r}: 'x0' or 'x1'")
    i = 0 if faces == "x0" else nex
    return np.arange(ney + 1, dtype=np.int64) * (nex + 1) + i
