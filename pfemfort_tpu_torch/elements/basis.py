# Copied from pfemfort_tpu/elements/basis.py.
"""Lagrange basis tabulation at quadrature points (host-side numpy, float64).

Node-ordering conventions follow the reference exactly so that meshes written
for it produce identical element matrices:
  * tria3 : N1 = 1-xi1-xi2, N2 = xi1, N3 = xi2
            (/root/reference/src/elementutilitiesbasisfuncs.F:41-51)
  * tria6 : corners (xi3^2, xi1^2, xi2^2) then midsides (2 xi1 xi3,
            2 xi1 xi2, 2 xi2 xi3)  (ibid:80-99)
  * quad4 : bilinear on [-1,1]^2, counter-clockwise (ibid:130-150)
  * tetra4: N1 = xi1, N2 = xi2, N3 = 1-xi1-xi2-xi3, N4 = xi3 — note the
            3rd node carries the "bubble" coordinate (ibid:263-281)
  * prism6: triangle x linear extrusion, bottom triangle first (ibid:387-414)
  * hexa8 : trilinear, lattice-bit order (x fastest) (ibid:323-357)
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

from pfemfort_tpu_torch.elements.quadrature import gauss_rule

# Default quadrature point count per element type (the counts the reference
# kernels use: tria3 1-pt, tria6 3-pt, quad4 4-pt, tetra4 1-pt, prism6 1-pt).
DEFAULT_NGP = {
    "tria3": 1,
    "tria6": 3,
    "quad4": 4,
    "tetra4": 1,
    "prism6": 1,
    "hexa8": 8,
}

QUAD_SHAPE = {
    "tria3": "tria",
    "tria6": "tria",
    "quad4": "quad",
    "tetra4": "tetra",
    "prism6": "prism",
    "hexa8": "hexa",
}


def _tria(degree: int, pts: np.ndarray):
    xi1, xi2 = pts[:, 0], pts[:, 1]
    xi3 = 1.0 - xi1 - xi2
    z = np.zeros_like(xi1)
    o = np.ones_like(xi1)
    if degree == 1:
        N = np.stack([xi3, xi1, xi2], axis=1)
        d1 = np.stack([-o, o, z], axis=1)
        d2 = np.stack([-o, z, o], axis=1)
        return N, np.stack([d1, d2], axis=1)
    if degree == 2:
        N = np.stack([xi3 * xi3, xi1 * xi1, xi2 * xi2,
                      2 * xi1 * xi3, 2 * xi1 * xi2, 2 * xi2 * xi3], axis=1)
        d1 = np.stack([-2 * xi3, 2 * xi1, z,
                       2 * (xi3 - xi1), 2 * xi2, -2 * xi2], axis=1)
        d2 = np.stack([-2 * xi3, z, 2 * xi2,
                       -2 * xi1, 2 * xi1, 2 * (xi3 - xi2)], axis=1)
        return N, np.stack([d1, d2], axis=1)
    raise ValueError(f"tria degree {degree}")


def _quad(pts: np.ndarray):
    xi, eta = pts[:, 0], pts[:, 1]
    v1, v2 = 1 - xi, 1 + xi
    v3, v4 = 1 - eta, 1 + eta
    N = 0.25 * np.stack([v3 * v1, v3 * v2, v4 * v2, v4 * v1], axis=1)
    d1 = 0.25 * np.stack([-v3, v3, v4, -v4], axis=1)
    d2 = 0.25 * np.stack([-v1, -v2, v2, v1], axis=1)
    return N, np.stack([d1, d2], axis=1)


def _tetra(pts: np.ndarray):
    xi1, xi2, xi3 = pts[:, 0], pts[:, 1], pts[:, 2]
    z = np.zeros_like(xi1)
    o = np.ones_like(xi1)
    N = np.stack([xi1, xi2, 1 - xi1 - xi2 - xi3, xi3], axis=1)
    d1 = np.stack([o, z, -o, z], axis=1)
    d2 = np.stack([z, o, -o, z], axis=1)
    d3 = np.stack([z, z, -o, o], axis=1)
    return N, np.stack([d1, d2, d3], axis=1)


def _prism(pts: np.ndarray):
    xi1, xi2, xi4 = pts[:, 0], pts[:, 1], pts[:, 2]
    xi3 = 1 - xi1 - xi2
    lo, hi = 0.5 * (1 - xi4), 0.5 * (1 + xi4)
    z = np.zeros_like(xi1)
    o = np.ones_like(xi1)
    N = np.stack([xi3 * lo, xi1 * lo, xi2 * lo,
                  xi3 * hi, xi1 * hi, xi2 * hi], axis=1)
    d1 = np.stack([-lo, lo, z, -hi, hi, z], axis=1)
    d2 = np.stack([-lo, z, lo, -hi, z, hi], axis=1)
    d3 = np.stack([-0.5 * xi3, -0.5 * xi1, -0.5 * xi2,
                   0.5 * xi3, 0.5 * xi1, 0.5 * xi2], axis=1)
    return N, np.stack([d1, d2, d3], axis=1)


def _hexa(pts: np.ndarray):
    xi1, xi2, xi3 = pts[:, 0], pts[:, 1], pts[:, 2]
    v11, v12 = 1 - xi1, 1 + xi1
    v21, v22 = 1 - xi2, 1 + xi2
    v31, v32 = 1 - xi3, 1 + xi3
    N = 0.125 * np.stack([
        v11 * v21 * v31, v12 * v21 * v31, v11 * v22 * v31, v12 * v22 * v31,
        v11 * v21 * v32, v12 * v21 * v32, v11 * v22 * v32, v12 * v22 * v32,
    ], axis=1)
    d1 = 0.125 * np.stack([
        -v21 * v31, v21 * v31, -v22 * v31, v22 * v31,
        -v21 * v32, v21 * v32, -v22 * v32, v22 * v32], axis=1)
    d2 = 0.125 * np.stack([
        -v11 * v31, -v12 * v31, v11 * v31, v12 * v31,
        -v11 * v32, -v12 * v32, v11 * v32, v12 * v32], axis=1)
    d3 = 0.125 * np.stack([
        -v11 * v21, -v12 * v21, -v11 * v22, -v12 * v22,
        v11 * v21, v12 * v21, v11 * v22, v12 * v22], axis=1)
    return N, np.stack([d1, d2, d3], axis=1)


@lru_cache(maxsize=None)
def tabulate_basis(etype: str, ngp: int | None = None):
    """Tabulate N and dN/dxi at the Gauss points of an element type.

    Returns (pts (G,pdim), wts (G,), N (G,npe), dNdu (G,pdim,npe)), float64.
    """
    if ngp is None:
        ngp = DEFAULT_NGP[etype]
    pts, wts = gauss_rule(QUAD_SHAPE[etype], ngp)
    if etype == "tria3":
        N, dNdu = _tria(1, pts)
    elif etype == "tria6":
        N, dNdu = _tria(2, pts)
    elif etype == "quad4":
        N, dNdu = _quad(pts)
    elif etype == "tetra4":
        N, dNdu = _tetra(pts)
    elif etype == "prism6":
        N, dNdu = _prism(pts)
    elif etype == "hexa8":
        N, dNdu = _hexa(pts)
    else:
        raise ValueError(f"unknown element type {etype!r}")
    return pts, wts, N, dNdu
