# Ported from pfemfort_tpu/drivers/poisson.py.
"""Poisson driver: the port's tetrapoissonparallelimpl1."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from pfemfort_tpu_torch.drivers.common import ImplicitResult, \
    solve_implicit, solve_implicit_fullsystem
from pfemfort_tpu_torch.dofs.dofmap import build_dofmap
from pfemfort_tpu_torch.elements.geometry import element_coords
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
from pfemfort_tpu_torch.mesh.core import Mesh
from pfemfort_tpu_torch.solve.cg import cg_solve, jacobi_preconditioner, \
    krylov_timings
from pfemfort_tpu_torch.solve.matfree import PoissonMatfree
from pfemfort_tpu_torch.utils.device import resolve_device, \
    synchronize as _sync
from pfemfort_tpu_torch.utils.timing import record, span

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
    device="cuda",
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
    matrix_free: assembly-free Jacobi-CG on the reduced system
    (solve/matfree.py); as in the JAX package it ignores bc_mode, method,
    precond and refine.
    device: 'cuda' (the default; raises without a card) or 'cpu'.
    """
    if bc_mode not in ("reduced", "full"):
        raise ValueError(f"bc_mode={bc_mode!r}: 'reduced' or 'full'")
    if source is None:
        source = _DEFAULT_SOURCE.get(mesh.etype, 0.0)
    if matrix_free:
        return _solve_poisson_matfree(mesh, dirichlet, kappa, af, source,
                                      device, dtype, rtol, maxiter)

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


def _solve_poisson_matfree(mesh, dirichlet, kappa, af, source, device, dtype,
                           rtol, maxiter) -> ImplicitResult:
    """Assembly-free CG: no global matrix is ever materialised.  Timings:
    pattern_s (DOF map, coordinates to the device), assemble_s (element
    geometry, sorted scatter, diagonal and rhs), solve_s, each ending in a
    device synchronise; krylov.loop_s, krylov.wait_s and krylov.host_reads
    (the CG loop's, solve/cg.py)."""
    device = resolve_device(device)
    if dtype is None:
        dtype = torch.get_default_dtype()
    timings = {}
    with span("pattern_s", timings):
        dofmap = build_dofmap(mesh, 1, dirichlet)
        coords_em = element_coords(mesh, dtype, device)
        ubc_e = torch.as_tensor(dofmap.bc_values_full[dofmap.elem_nodedof].T,
                                dtype=dtype, device=device)
        _sync(device)

    with span("assemble_s", timings):
        operator = PoissonMatfree(coords_em, mesh.etype, dofmap, kappa=kappa,
                                  af=af)
        diag = operator.diagonal()
        # rhs: source term + matrix-free Dirichlet elimination
        _, Fe_src = poisson_element_matrices(coords_em, mesh.etype,
                                             kappa=kappa, af=af,
                                             source=source)
        del coords_em
        b = operator.segments.sum(Fe_src - operator.element_apply(ubc_e))
        del Fe_src, ubc_e
        _sync(device)

    n = dofmap.total_dof
    if maxiter is None:
        maxiter = max(10 * n, 1000)
    with span("solve_s", timings):
        u, stats = cg_solve(operator, b, precond=jacobi_preconditioner(diag),
                            rtol=rtol, maxiter=maxiter)
        _sync(device)
    timings.update(krylov_timings(stats))
    u_full = dofmap.expand_solution(u.cpu().to(torch.float64).numpy())
    record("solve_poisson_matfree", timings)
    return ImplicitResult(u_full=u_full, u_reduced=u, stats=stats,
                          timings=timings)
