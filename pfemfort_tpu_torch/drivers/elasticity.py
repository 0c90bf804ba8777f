# Ported from pfemfort_tpu/drivers/elasticity.py.
"""Implicit linear-elasticity drivers: the port's
triaelasticityparallelimpl1 (2D, plane stress) and
tetraelasticityparallelimpl1 (3D)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from pfemfort_tpu_torch.drivers.common import ImplicitResult, \
    solve_implicit, solve_implicit_fullsystem
from pfemfort_tpu_torch.elements.elasticity import (
    dmat_3d,
    dmat_plane_strain,
    dmat_plane_stress,
    elasticity_stiffness,
)
from pfemfort_tpu_torch.mesh.core import Mesh

# the preconditioners of the full system (drivers/common.py:
# solve_implicit_fullsystem)
_FULL_PRECONDS = ("jacobi", "mg")


def solve_elasticity(
    mesh: Mesh,
    dirichlet: np.ndarray,
    E: float,
    nu: float,
    force_bc: Optional[np.ndarray] = None,
    bforce: Optional[Sequence[float]] = None,
    thickness: float = 1.0,
    plane: str = "stress",
    device="cuda",
    dtype: Optional[torch.dtype] = None,
    rtol: float = 1e-8,
    maxiter: Optional[int] = None,
    method: str = "cg",
    refine: bool = False,
    bc_mode: str = "reduced",
    precond: str = "jacobi",
) -> ImplicitResult:
    """Static linear elasticity K u = F with Dirichlet + nodal Force BCs.

    The reference's implicit 2D path is plane STRESS
    (PFEMFort src/elementutilitieselasticity2D.F:61-66) — that is the
    default here; pass plane='strain' for the explicit-dynamics constitutive
    law.  3D uses the standard isotropic D
    (PFEMFort src/elementutilitieselasticity3D.F:287-296).
    device, dtype: as in drivers/common.py:solve_implicit.

    The reduced system (bc_mode='reduced') is preconditioned by `precond`,
    any that drivers/common.py:solve_implicit takes ('jacobi', 'cheby',
    'ic0', 'amg'; 'mg' is the full system's and gives Jacobi there);
    timings["precond_used"] says which ran (the JAX package's reduced
    elasticity is always Jacobi, pfemfort_tpu/drivers/elasticity.py:65-68).
    'ic0' is the reference's own solver on one rank: PETSc CG with
    block Jacobi, whose one block is ILU(0), IC(0) on this SPD system
    (src/solverpetsc.F:187,206).  bc_mode='full' solves the full node-dof
    system with identity Dirichlet rows, preconditioned by 'jacobi' or
    'mg'; any other `precond` raises ValueError there.
    refine: float32-inner / float64-outer refinement of the reduced system,
    its inner CG Jacobi-preconditioned: with any other `precond` it raises
    ValueError (the full system ignores refine).
    """
    if bc_mode not in ("reduced", "full"):
        raise ValueError(f"bc_mode={bc_mode!r}: 'reduced' or 'full'")
    if bc_mode == "full" and precond not in _FULL_PRECONDS:
        raise ValueError(f"precond={precond!r} with bc_mode='full': one of "
                         f"{list(_FULL_PRECONDS)}")
    if refine and bc_mode == "reduced" and precond != "jacobi":
        raise ValueError(f"precond={precond!r} with refine=True: the "
                         "refined solve's inner CG is Jacobi-preconditioned")
    ndim = mesh.ndim
    if ndim == 2:
        D = dmat_plane_stress(E, nu) if plane == "stress" \
            else dmat_plane_strain(E, nu)
    else:
        D = dmat_3d(E, nu)

    def element_fn(coords_em):
        return elasticity_stiffness(
            coords_em, mesh.etype, D,
            thickness=thickness if ndim == 2 else 1.0,
            bforce=bforce)

    if bc_mode == "full":
        return solve_implicit_fullsystem(
            mesh, ndim, dirichlet, element_fn, force_bc=force_bc,
            device=device, dtype=dtype, rtol=rtol, maxiter=maxiter,
            method=method, precond=precond)
    return solve_implicit(
        mesh, ndim, dirichlet, element_fn, force_bc=force_bc, device=device,
        dtype=dtype, rtol=rtol, maxiter=maxiter, method=method,
        refine=refine, precond=precond)
