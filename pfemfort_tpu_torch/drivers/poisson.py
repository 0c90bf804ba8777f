# Ported from pfemfort_tpu/drivers/poisson.py (reduced BCs, Jacobi-CG).
"""Poisson driver: the port's tetrapoissonparallelimpl1."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from pfemfort_tpu_torch.drivers.common import ImplicitResult, solve_implicit
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
from pfemfort_tpu_torch.mesh.core import Mesh

# The reference drivers hard-code the source term: 0 for the 2D problems
# (elementutilitiespoisson.F:83) and -6 for the 3D manufactured solution
# u = x^2+y^2+z^2 (elementutilitiespoisson.F:172).
_DEFAULT_SOURCE = {"tetra4": -6.0}


def solve_poisson(
    mesh: Mesh,
    dirichlet: np.ndarray,
    kappa: Optional[Sequence[float]] = None,
    source=None,
    af: float = 1.0,
    device="cpu",
    dtype: Optional[torch.dtype] = None,
    rtol: float = 1e-8,
    maxiter: Optional[int] = None,
    method: str = "cg",
    bc_mode: str = "reduced",
    precond: str = "jacobi",
    refine: bool = False,
    matrix_free: bool = False,
) -> ImplicitResult:
    """Solve -div(kappa grad u) = source with Dirichlet BCs.

    Matches the reference drivers' defaults: kappa = 1 per axis, source -6
    for tetra4, CG + Jacobi to relative tolerance, BC dofs eliminated from
    the system.  `source` is a constant or a callable f(xg) -> (G, E) of the
    (G, ndim, E) Gauss-point coordinate tensor.
    """
    if refine:
        raise NotImplementedError(
            "refine=True waits for ROADMAP A.7 (precision)")
    if matrix_free:
        raise NotImplementedError(
            "matrix_free=True waits for ROADMAP A.8 (matrix-free)")
    if bc_mode != "reduced":
        raise NotImplementedError(
            f"bc_mode={bc_mode!r}: only 'reduced' is ported; the full "
            "system waits for ROADMAP A.6")
    if source is None:
        source = _DEFAULT_SOURCE.get(mesh.etype, 0.0)

    def element_fn(coords_em):
        return poisson_element_matrices(
            coords_em, mesh.etype, kappa=kappa, af=af, source=source)

    return solve_implicit(
        mesh, 1, dirichlet, element_fn, device=device, dtype=dtype,
        rtol=rtol, maxiter=maxiter, method=method, precond=precond)
