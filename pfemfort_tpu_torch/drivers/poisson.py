# Ported from pfemfort_tpu/drivers/poisson.py (all but the matrix-free path).
"""Poisson driver: the port's tetrapoissonparallelimpl1."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from pfemfort_tpu_torch.drivers.common import ImplicitResult, \
    solve_implicit, solve_implicit_fullsystem
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

    bc_mode: 'reduced' eliminates BC dofs from the system (impl1/impl2
    semantics); 'full' keeps the full-size system with MatZeroRows identity
    rows (impl3 semantics, triapoissonserialimpl3.F:557-558).
    precond: 'jacobi', 'cheby', 'ic0' or 'amg' (reduced mode), or 'mg'
    (geometric multigrid; bc_mode='full' on structured lattice meshes, else
    Jacobi).  timings["precond_used"] says which one ran.
    refine: float32-inner / float64-outer iterative refinement of the
    reduced system (ignored with bc_mode='full', as in the JAX package).
    """
    if matrix_free:
        raise NotImplementedError(
            "matrix_free=True waits for ROADMAP A.8 (matrix-free)")
    if bc_mode not in ("reduced", "full"):
        raise ValueError(f"bc_mode={bc_mode!r}: 'reduced' or 'full'")
    if source is None:
        source = _DEFAULT_SOURCE.get(mesh.etype, 0.0)

    def element_fn(coords_em):
        return poisson_element_matrices(
            coords_em, mesh.etype, kappa=kappa, af=af, source=source)

    if bc_mode == "full":
        return solve_implicit_fullsystem(
            mesh, 1, dirichlet, element_fn, device=device, dtype=dtype,
            rtol=rtol, maxiter=maxiter, method=method, precond=precond)
    return solve_implicit(
        mesh, 1, dirichlet, element_fn, device=device, dtype=dtype,
        rtol=rtol, maxiter=maxiter, method=method, refine=refine,
        precond=precond)
