# Ported from pfemfort_tpu/elements/poisson.py.
"""Batched Poisson element kernels (torch) — element-minor layout.

One pass of elementwise tensor ops over ALL elements (element axis last —
see geometry.py) in place of the reference's per-element subroutine
StiffnessResidualPoissonLinearTria/Tetra
(/root/reference/src/elementutilitiespoisson.F:23-101, 107-193).

Math (identical to the reference):
  K[i,j] = af * sum_g w_g |J|_g * sum_d kappa_d dN_i/dx_d dN_j/dx_d
  F[i]   = sum_g w_g |J|_g * N_i * source
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from pfemfort_tpu_torch.elements.basis import tabulate_basis
from pfemfort_tpu_torch.elements.geometry import grads_and_det

SourceLike = Union[float, Callable]


def poisson_element_matrices(
    coords_em: torch.Tensor,
    etype: str,
    kappa: Optional[Sequence[float]] = None,
    af: float = 1.0,
    source: SourceLike = 0.0,
    ngp: Optional[int] = None,
):
    """Element stiffness and source vectors for all elements at once.

    Args:
      coords_em: (npe, ndim, E) tensor of element nodal coordinates
                 (element-minor; see geometry.to_element_minor).  Its dtype
                 and device are those of the results.
      etype:    element type name.
      kappa:    diffusivity per axis (kx, ky[, kz]); default all ones.
      af:       generalized-alpha factor multiplying K (always 1.0 in the
                reference drivers).
      source:   constant source, or callable f(xg)->(G,E) evaluated at
                physical Gauss-point coordinates xg (G,ndim,E).
    Returns:
      K (npe, npe, E), F (npe, E).
    """
    dtype, device = coords_em.dtype, coords_em.device
    pts, wts, N, dNdu = tabulate_basis(etype, ngp)
    ndim = dNdu.shape[1]
    if kappa is None:
        kappa = np.ones(ndim)
    kappa = torch.as_tensor(np.asarray(kappa, dtype=np.float64),
                            dtype=dtype, device=device)
    wts = torch.as_tensor(wts, dtype=dtype, device=device)
    Nj = torch.as_tensor(N, dtype=dtype, device=device)

    gradN, det = grads_and_det(coords_em, dNdu)   # (G,d,i,E), (G,E)
    dvol = wts[:, None] * det                     # (G, E)
    G, pdim, npe = dNdu.shape

    # K[i,j,e] = af * sum_{g,d} dvol kappa_d gradN[g,d,i,e] gradN[g,d,j,e]
    wgrad = gradN * (dvol[:, None, None, :] * kappa[None, :, None, None])
    K = af * sum(
        wgrad[g, d][:, None, :] * gradN[g, d][None, :, :]
        for g in range(G) for d in range(pdim)
    )

    if callable(source):
        xg = sum(Nj[:, i][:, None, None] * coords_em[i][None, :, :]
                 for i in range(npe))  # (G, ndim, E)
        f = source(xg)  # (G, E)
    else:
        f = torch.full(dvol.shape, float(source), dtype=dtype, device=device)
    df = dvol * f
    F = sum(df[g][None, :] * Nj[g][:, None] for g in range(G))
    return K, F


def poisson_matfree_apply(
    u_e: torch.Tensor,
    gradN: torch.Tensor,
    dvol: torch.Tensor,
    kappa: torch.Tensor,
    af: float = 1.0,
) -> torch.Tensor:
    """Matrix-free K_e @ u_e for all elements (for assembly-free CG).

    u_e (npe, E); gradN (G, d, npe, E); dvol (G, E); returns (npe, E).
    """
    G, pdim, npe, _ = gradN.shape
    du = sum(gradN[:, :, j, :] * u_e[j][None, None, :]
             for j in range(npe))                                # grad u
    flux = du * kappa[None, :, None] * dvol[:, None, :]
    return af * sum(gradN[g, d] * flux[g, d][None, :]
                    for g in range(G) for d in range(pdim))
