# Ported from pfemfort_tpu/elements/geometry.py.
"""Batched isoparametric geometry (torch) — element-minor layout.

Jacobians, determinants and physical gradients for ALL elements at ALL
Gauss points in one pass of elementwise tensor ops (the reference computes
them per element: /root/reference/src/elementutilitiesbasisfuncs.F:165-234,
430-538).

The element axis E is LAST, as in the JAX package: the public functions
take and return the same layouts, and on the card E-last keeps every
elementwise pass coalesced (neighbouring threads on neighbouring elements).
The tiny (pdim x pdim) inverses are closed-form.

Every way a mesh's element coordinates reach a solver is made here: the
host gather, an affine box made on the device, a rank's padded block.

Index conventions (matching the Fortran):
  J[g,a,d,e] = sum_i dNdu[g,a,i] * coords[i,d,e]     ("B" in the reference)
  gradN[g,d,i,e] = sum_a inv(J)[g,d,a,e] * dNdu[g,a,i]
  det[g,e] = det(J[g,e])                              ("Jac")
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pfemfort_tpu_torch.mesh.core import Mesh
from pfemfort_tpu_torch.mesh.generate import box_tet_coords_em_device


def to_element_minor(coords_e: np.ndarray) -> np.ndarray:
    """(E, npe, ndim) host array -> (npe, ndim, E) contiguous."""
    return np.ascontiguousarray(np.transpose(coords_e, (1, 2, 0)))


def element_coords(mesh: Mesh, dtype: torch.dtype, device) -> torch.Tensor:
    """(npe, ndim, E) element-minor coordinates of `mesh` on `device`: the
    host gather through the connectivity, transposed, copied once."""
    return torch.as_tensor(to_element_minor(mesh.elem_coords()), dtype=dtype,
                           device=device)


def affine_box_bounds(mesh: Mesh) -> Optional[tuple]:
    """Bounds per axis when `mesh` is a box_tet whose node coords ARE the
    separable affine lattice (so they can be made on the device); None
    otherwise."""
    s = mesh.structure or {}
    if s.get("kind") != "box_tet":
        return None
    shape = (s["nez"] + 1, s["ney"] + 1, s["nex"] + 1)
    c = mesh.coords.reshape(*shape, 3)
    lo = mesh.coords.min(axis=0)
    hi = mesh.coords.max(axis=0)
    for ax in range(3):
        axis_dim = 2 - ax
        want = np.linspace(lo[ax], hi[ax], c.shape[axis_dim])
        sl = [0, 0, 0, ax]
        sl[axis_dim] = slice(None)
        if not np.allclose(c[tuple(sl)], want, atol=1e-12 + 1e-9 *
                           max(abs(lo[ax]), abs(hi[ax]))):
            return None
        # separability: the coordinate must not vary along the other axes
        var = c[..., ax]
        red = tuple(d for d in range(3) if d != axis_dim)
        if float(np.abs(var.max(axis=red) - var.min(axis=red)).max()) > 1e-9:
            return None
    return tuple((float(lo[a]), float(hi[a])) for a in range(3))


def box_element_coords(mesh: Mesh, bounds: Optional[tuple],
                       dtype: torch.dtype, device) -> torch.Tensor:
    """A box_tet mesh's element coordinates made on `device` from `bounds`
    (`affine_box_bounds`; they round differently from the gather), or
    `element_coords` when `bounds` is None."""
    if bounds is None:
        return element_coords(mesh, dtype, device)
    s = mesh.structure
    (x0, x1), (y0, y1), (z0, z1) = bounds
    return box_tet_coords_em_device(x0, x1, s["nex"], y0, y1, s["ney"],
                                    z0, z1, s["nez"], dtype=dtype,
                                    device=device)


def rank_element_coords(mesh: Mesh, els: np.ndarray,
                        width: int) -> np.ndarray:
    """(npe, ndim, width) float64 host coordinates of the elements `els`,
    padded with element 0's (a padding element's kernel stays finite)."""
    coords = np.empty((mesh.npe, mesh.ndim, width), dtype=np.float64)
    coords[:] = mesh.coords[mesh.conn[0]][:, :, None]
    coords[:, :, :len(els)] = to_element_minor(mesh.coords[mesh.conn[els]])
    return coords


def _det_inv_2x2(J: torch.Tensor):
    # J (G, 2, 2, E)
    a, b = J[:, 0, 0], J[:, 0, 1]
    c, d = J[:, 1, 0], J[:, 1, 1]
    det = a * d - b * c
    inv = torch.stack([
        torch.stack([d, -b], dim=1),
        torch.stack([-c, a], dim=1),
    ], dim=1) / det[:, None, None]
    return det, inv


def _det_inv_3x3(J: torch.Tensor):
    a = J[:, 0, 0]; b = J[:, 0, 1]; c = J[:, 0, 2]
    d = J[:, 1, 0]; e = J[:, 1, 1]; f = J[:, 1, 2]
    g = J[:, 2, 0]; h = J[:, 2, 1]; i = J[:, 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv = torch.stack([
        torch.stack([A, -(b * i - c * h), (b * f - c * e)], dim=1),
        torch.stack([B, (a * i - c * g), -(a * f - c * d)], dim=1),
        torch.stack([C, -(a * h - b * g), (a * e - b * d)], dim=1),
    ], dim=1) / det[:, None, None]
    return det, inv


def grads_and_det(coords_em: torch.Tensor, dNdu):
    """Physical gradients and Jacobian determinants, element-minor.

    Args:
      coords_em: (npe, ndim, E) element nodal coordinates.
      dNdu:      (G, pdim, npe) parametric derivatives (static host table).
    Returns:
      gradN: (G, ndim, npe, E)  physical derivatives dN/dx_d,
      det:   (G, E)             Jacobian determinant ("Jac").
    """
    dN = torch.as_tensor(np.asarray(dNdu, dtype=np.float64),
                         dtype=coords_em.dtype, device=coords_em.device)
    G, pdim, npe = dN.shape
    # J[g,a,d,e] = sum_i dNdu[g,a,i] * coords[i,d,e], summed in node order
    J = sum(dN[:, :, i, None, None] * coords_em[i][None, None, :, :]
            for i in range(npe))
    if J.shape[2] == 2:
        det, inv = _det_inv_2x2(J)
    else:
        det, inv = _det_inv_3x3(J)
    # gradN[g,d,i,e] = sum_a inv[g,d,a,e] * dNdu[g,a,i]
    gradN = sum(inv[:, :, a, None, :] * dN[:, a, :][:, None, :, None]
                for a in range(pdim))
    return gradN, det
