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

Index conventions (matching the Fortran):
  J[g,a,d,e] = sum_i dNdu[g,a,i] * coords[i,d,e]     ("B" in the reference)
  gradN[g,d,i,e] = sum_a inv(J)[g,d,a,e] * dNdu[g,a,i]
  det[g,e] = det(J[g,e])                              ("Jac")
"""

from __future__ import annotations

import numpy as np
import torch


def to_element_minor(coords_e: np.ndarray) -> np.ndarray:
    """(E, npe, ndim) host array -> (npe, ndim, E) contiguous."""
    return np.ascontiguousarray(np.transpose(coords_e, (1, 2, 0)))


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
