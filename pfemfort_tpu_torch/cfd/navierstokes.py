# Ported from pfemfort_tpu/cfd/navierstokes.py (host step loop in place of lax.scan).
"""Incompressible Navier-Stokes: explicit fractional-step (Chorin) solver,
dimension-generic (2D tria3/tria6/quad4 and 3D tetra4/hexa8/prism6).

The reference ships only abandoned scaffolding for this capability
(cfdexplicittria6node.F calls a nonexistent residual and its update is
commented out; elementutilitiescfd.F does not compile and holds both a tria
and a tetra kernel intent, PFEMFort src/elementutilitiescfd.F:23, 417).
This is the JAX package's working equal-order fractional-step scheme, built
from the ingredients the reference intended (lumped velocity mass, nodal
momentum residual, pressure Poisson solve):

  1. u* = u^n + dt M_L^{-1} R(u^n)        momentum: convection + viscosity
  2. L p = -(1/dt) int N div u*           pressure Poisson (DIA/ELL CG)
  3. u^{n+1} = u* - dt M_L^{-1} G p       projection

The time loop runs on the host with the state on the device.  Element
operations are batched element-minor tensor ops unrolled over the (static)
spatial dimension; nodal sums use the assembly's `Segments` (destinations
sorted once, no atomics, bit-repeatable on the card); the pressure operator
is assembled once and applied through sparse/ops.py:operator_and_diag
(kernel B1 when the mesh numbering gives a DIA pattern, kernel B2
otherwise).  Each step runs one warm-started CG, which reads one flag per
iteration; nothing else syncs: max |div u| of every step goes into a
device buffer read once at the end.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from pfemfort_tpu_torch.assembly.assemble import Segments, \
    assemble_matrix, build_assembly_plan
from pfemfort_tpu_torch.assembly.pattern import build_pattern
from pfemfort_tpu_torch.dofs.dofmap import build_dofmap
from pfemfort_tpu_torch.elements.basis import tabulate_basis
from pfemfort_tpu_torch.elements.geometry import grads_and_det, \
    to_element_minor
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
from pfemfort_tpu_torch.mesh.core import Mesh
from pfemfort_tpu_torch.solve.cg import cg_solve, jacobi_preconditioner
from pfemfort_tpu_torch.sparse.ops import operator_and_diag
from pfemfort_tpu_torch.utils.device import resolve_device

# The pressure CG's iteration cap, as in the JAX package; a step that hits
# it goes on unconverged, as there (NSResult.cg_iters shows it).
PRESSURE_CG_MAXITER = 2000


class NSResult(NamedTuple):
    velocity: np.ndarray     # (n_node, ndim)
    pressure: np.ndarray     # (n_node,)
    div_history: np.ndarray  # (nsteps,) max |div u| after each projection
    times: np.ndarray
    cg_iters: Optional[np.ndarray] = None   # (nsteps,) pressure CG counts


def fractional_step_ns(
    mesh: Mesh,
    velocity_bc: np.ndarray,   # (n, 3) [node, dof(0..ndim-1), value]
    nu_visc: float,
    dt: float,
    nsteps: int,
    pressure_pin: Optional[int] = None,
    u0: Optional[np.ndarray] = None,
    rtol_p: float = 1e-8,
    sample_every: int = 10,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
) -> NSResult:
    """Run the fractional-step scheme on any supported mesh (2D or 3D).

    velocity_bc fixes velocity components (e.g. lid-driven cavity/cube
    walls).  pressure_pin: node whose pressure is fixed to 0 (default: 0).
    device: 'cuda' (the default; raises without a card) or 'cpu'; dtype
    None means torch.get_default_dtype().  `sample_every` is accepted for
    the JAX package's signature and unused there too.
    """
    device = resolve_device(device)
    if dtype is None:
        dtype = torch.get_default_dtype()
    n = mesh.n_node
    nd = mesh.ndim
    if pressure_pin is None:
        pressure_pin = 0
    as_dev = lambda a: torch.as_tensor(a, dtype=dtype, device=device)

    # --- static tables -----------------------------------------------------
    _, wts, N, dNdu = tabulate_basis(mesh.etype, 1)
    coords_em = as_dev(to_element_minor(mesh.elem_coords()))
    gradN, det = grads_and_det(coords_em, dNdu)   # (G, nd, npe, E), (G, E)
    dvol = as_dev(wts)[:, None] * det             # (G, E)

    conn_t = torch.as_tensor(mesh.conn.T.astype(np.int64), device=device)
    npe = mesh.npe
    G = dNdu.shape[0]
    Njd = as_dev(np.asarray(N, dtype=np.float64))
    nodes = Segments.from_dest(conn_t.reshape(-1), n + 1)

    def scatter(Fe):
        """(npe, E) element vector -> (n,) nodal sum."""
        return nodes.sum(Fe)

    # lumped velocity mass (per node, density 1)
    Mn_e = torch.stack([sum(Njd[g, i] * dvol[g] for g in range(G))
                        for i in range(npe)])              # (npe, E)
    M = scatter(Mn_e)
    Minv = torch.where(M > 0, 1.0 / M, 1.0)

    # pressure Poisson operator: Dirichlet pin at one node
    pin_bc = np.array([[pressure_pin, 0, 0.0]])
    dof_p = build_dofmap(mesh, 1, pin_bc)
    plan_p = build_assembly_plan(
        build_pattern(dof_p.elem_dof, dof_p.total_dof), device)
    Kp, _ = poisson_element_matrices(coords_em, mesh.etype)
    op_p, diag_p = operator_and_diag(assemble_matrix(Kp, plan_p))
    del Kp, coords_em
    pre_p = jacobi_preconditioner(diag_p)
    scatter_p = torch.as_tensor(dof_p.assy_for_soln, device=device)

    # velocity BC masks
    vbc_mask = np.zeros((nd, n), dtype=bool)
    vbc_val = np.zeros((nd, n))
    if velocity_bc is not None and len(velocity_bc):
        nn = velocity_bc[:, 0].astype(np.int64)
        dd = velocity_bc[:, 1].astype(np.int64)
        vbc_mask[dd, nn] = True
        vbc_val[dd, nn] = velocity_bc[:, 2]
    vbc_mask = torch.as_tensor(vbc_mask, device=device)
    vbc_val = as_dev(vbc_val)

    def gp_value(comp_em):
        """Nodal values (npe, E) -> gauss-point values (G, E)."""
        return sum(Njd[:, i][:, None] * comp_em[i][None, :]
                   for i in range(npe))

    def gp_grad(comp_em, a):
        """d(comp)/dx_a at gauss points, (G, E)."""
        return sum(gradN[:, a, i, :] * comp_em[i][None, :]
                   for i in range(npe))

    def apply_vbc(U):
        return torch.where(vbc_mask, vbc_val, U)

    def momentum_residual(U_em):
        """R_i^c = -int N_i (u . grad)u_c - nu int gradN_i . grad u_c.

        U_em: (nd, npe, E) nodal velocities; returns (nd, npe, E)."""
        Ug = [gp_value(U_em[c]) for c in range(nd)]             # (G, E)
        dU = [[gp_grad(U_em[c], a) for a in range(nd)]
              for c in range(nd)]                               # [c][a]
        conv = [sum(Ug[a] * dU[c][a] for a in range(nd))
                for c in range(nd)]
        out = []
        for c in range(nd):
            rows = []
            for i in range(npe):
                r = sum(dvol[g] * (-Njd[g, i] * conv[c][g]
                                   - nu_visc * sum(
                                       gradN[g, a, i, :] * dU[c][a][g]
                                       for a in range(nd)))
                        for g in range(G))
                rows.append(r)
            out.append(torch.stack(rows))
        return torch.stack(out)

    def nodal_div_rhs(U):
        """b_i = int N_i div(u) (n,), plus gauss-point divergence (G, E)."""
        U_em = U[:, conn_t]                                     # (nd,npe,E)
        div_g = sum(gp_grad(U_em[c], c) for c in range(nd))
        Fe = torch.stack([sum(dvol[g] * Njd[g, i] * div_g[g]
                              for g in range(G)) for i in range(npe)])
        return scatter(Fe), div_g

    def pressure_gradient(p):
        """nodal weak gradient: (G p)_i^a = int N_i dp/dx_a -> (nd, n)."""
        p_em = p[conn_t]
        out = []
        for a in range(nd):
            dpda = gp_grad(p_em, a)
            Fa = torch.stack([sum(dvol[g] * Njd[g, i] * dpda[g]
                                  for g in range(G)) for i in range(npe)])
            out.append(scatter(Fa))
        return torch.stack(out)

    if u0 is None:
        U = torch.zeros((nd, n), dtype=dtype, device=device)
    else:
        U = as_dev(np.asarray(u0).T)
    U = apply_vbc(U)
    p = torch.zeros((n,), dtype=dtype, device=device)
    divs = torch.empty(nsteps, dtype=dtype, device=device)
    cg_iters = np.zeros(nsteps, dtype=np.int64)

    for k in range(nsteps):
        # 1. explicit momentum
        R_e = momentum_residual(U[:, conn_t])
        Us = U + dt * Minv[None, :] * torch.stack(
            [scatter(R_e[c]) for c in range(nd)])
        Us = apply_vbc(Us)
        # 2. pressure Poisson.  The discrete div-of-gradient D M^-1 G
        # approximates -L (integration by parts flips the sign), so removing
        # the divergence requires  L p = -(1/dt) int N div u*.
        bdiv, _ = nodal_div_rhs(Us)
        p_red, st = cg_solve(op_p, (-bdiv / dt)[scatter_p],
                             x0=p[scatter_p], precond=pre_p, rtol=rtol_p,
                             maxiter=PRESSURE_CG_MAXITER)
        cg_iters[k] = st.iters
        p = torch.zeros((n,), dtype=dtype, device=device)
        p[scatter_p] = p_red
        # 3. projection
        U = apply_vbc(Us - dt * Minv[None, :] * pressure_gradient(p))
        _, div_g = nodal_div_rhs(U)
        divs[k] = div_g.abs().max()

    return NSResult(
        velocity=U.cpu().to(torch.float64).numpy().T,
        pressure=p.cpu().to(torch.float64).numpy(),
        div_history=divs.cpu().numpy(),
        times=np.arange(nsteps) * dt,
        cg_iters=cg_iters,
    )
