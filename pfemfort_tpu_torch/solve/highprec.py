# Ported from pfemfort_tpu/solve/highprec.py (native float64; no stencil64, no double-float).
"""Full-system 1e-8 float64 solve of the box-tet Poisson problem at any
size on one card: float64 assembly on the card + multigrid-preconditioned
float32 inner CG + float64 outer refinement.

The composition that matches the reference's flagship run (48M tets solved
in float64 by PETSc CG across 40 MPI ranks, PFEMFort README.md:19-21,
solverpetsc.F:476-490):

  * the float64 FULL system (all node-dofs, identity Dirichlet rows) is
    assembled on the card: element-minor coordinates generated on the card
    for an affine box (mesh/generate.py:box_tet_coords_em_device), the
    structured slice-add assembly (z-slab chunks above 12M elements), then
    MatZeroRows (assembly/fullsystem.py);
  * inner solves run float32 CG on that system cast to float32,
    preconditioned by geometric multigrid whose FINE level is the same
    float32 values with Dirichlet rows AND columns symmetrized to identity
    (so no fine-level re-assembly for the hierarchy: solve/multigrid.py
    `fine_matrix=`);
  * the outer loop computes the TRUE float64 residual through kernel B1 in
    float64 and accumulates x in float64 (solve/refine.py).

The JAX package built this system on the host as an exact float64 stencil
and carried it on the TPU as a double-float (hi, lo) float32 pair, because
a TPU has no float64; the card has, so neither is carried over.

Iteration economics: a few outer cycles of ~10 MG-CG inner iterations in
place of the O(n) Jacobi-CG count (546 at n=200).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pfemfort_tpu_torch.assembly import structured as st
from pfemfort_tpu_torch.assembly.fullsystem import zero_dirichlet_rows
from pfemfort_tpu_torch.elements.geometry import to_element_minor
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
from pfemfort_tpu_torch.mesh import generate as gen
from pfemfort_tpu_torch.mesh.core import Mesh
from pfemfort_tpu_torch.solve.multigrid import _is_affine_box, build_gmg, \
    gmg_preconditioner, symmetrize_dirichlet
from pfemfort_tpu_torch.solve.cg import krylov_timings
from pfemfort_tpu_torch.solve.refine import cg_with_refinement
from pfemfort_tpu_torch.sparse.ops import dia_operator
from pfemfort_tpu_torch.utils.device import resolve_device, \
    synchronize as _sync
from pfemfort_tpu_torch.utils.timing import record, span


def lattice_bc(mesh: Mesh, dirichlet: np.ndarray):
    """(bc_mask (n,), bc_values (n,)) from (node, dof, value) rows, ndof=1,
    without building the full DofMap (which materialises O(E*npe) arrays
    the structured path never needs)."""
    n = mesh.n_node
    bc_mask = np.zeros(n, dtype=bool)
    bc_vals = np.zeros(n, dtype=np.float64)
    if dirichlet is not None and len(dirichlet):
        nodes = dirichlet[:, 0].astype(np.int64)
        bc_mask[nodes] = True
        bc_vals[nodes] = dirichlet[:, 2]
    return bc_mask, bc_vals


def full_system_f64(mesh: Mesh, element_fn, bc_mask: torch.Tensor,
                    bc_vals: torch.Tensor, device,
                    timings: Optional[dict] = None):
    """(A (DIA, identity Dirichlet rows), b) of the float64 full system of
    a box_tet mesh, assembled on `device`; and the assembly's chunk
    count.  `timings`: where the span assemble.affine_s (the host's check
    that the mesh is an affine box) goes."""
    s = mesh.structure
    nex, ney, nez = s["nex"], s["ney"], s["nez"]
    f64 = torch.float64
    with span("assemble.affine_s", timings):
        bounds = _is_affine_box(mesh)
    if bounds is not None:
        (x0, x1), (y0, y1), (z0, z1) = bounds
        coords = gen.box_tet_coords_em_device(x0, x1, nex, y0, y1, ney,
                                              z0, z1, nez, dtype=f64,
                                              device=device)
    else:
        coords = torch.as_tensor(to_element_minor(mesh.elem_coords()),
                                 dtype=f64, device=device)
    plan = st.build_structured_plan(nex, ney, nez, ndof=1)
    n_chunks = st.chunk_count(nez, mesh.n_elem)
    if n_chunks > 1:
        A, b = st.assemble_structured_chunked(element_fn, coords, plan,
                                              n_chunks)
    else:
        Ke, Fe = element_fn(coords)
        A = st.assemble_dia_structured(Ke, plan)
        b = st.assemble_rhs_structured(Fe, plan)
        del Ke, Fe
    del coords
    A, b = zero_dirichlet_rows(A, b, bc_mask, bc_vals)
    return A, b, n_chunks


def solve_box_poisson_1e8(
    mesh: Mesh,
    dirichlet: np.ndarray,
    rtol: float = 1e-8,
    inner_rtol: float = 1e-4,
    inner_maxiter: int = 100,
    max_outer: int = 20,
    nu: int = 1,
    omega: float = 0.8,
    source: float = -6.0,
    coarsest_max_dof: int = 4096,
    device="cuda",
):
    """Solve the box-tet Poisson problem to a TRUE <= rtol float64 relative
    residual of the float64 full system.

    device: 'cuda' (the default; raises without a card) or 'cpu'.
    Returns (u_full (n_node,) float64 numpy, RefineStats, timings) with
    timings host_assemble_s (the float64 system on the device; inside it
    assemble.affine_s, the host's affine-box check of the fine mesh),
    mg_setup_s (inside it mg.coarsen_s, the host coarsening chain),
    mg_levels, solve_s and assembly_chunks, and the inner CG loops'
    krylov.loop_s, krylov.wait_s and krylov.host_reads (RefineStats' sums,
    solve/refine.py).  Each stage ends in a device synchronise; the
    children do not (utils/timing.py:span).
    """
    device = resolve_device(device)
    s = mesh.structure or {}
    if s.get("kind") != "box_tet":
        raise ValueError("solve_box_poisson_1e8 needs a generated box_tet "
                         "mesh")
    timings = {}
    element_fn = lambda c: poisson_element_matrices(c, "tetra4",
                                                    source=source)

    with span("host_assemble_s", timings):
        bc_mask_np, bc_vals_np = lattice_bc(mesh, dirichlet)
        bc_mask = torch.as_tensor(bc_mask_np, device=device)
        bc_vals = torch.as_tensor(bc_vals_np, dtype=torch.float64,
                                  device=device)
        A64, b64, n_chunks = full_system_f64(mesh, element_fn, bc_mask,
                                             bc_vals, device, timings)
        _sync(device)
    timings["assembly_chunks"] = n_chunks

    with span("mg_setup_s", timings):
        # inner operator: the float64 system rounded to float32; MG's fine
        # level: the same values with identity BC rows AND columns
        # (pfemfort_tpu/solve/highprec.py:140-155)
        A32 = dataclasses.replace(A64, vals=A64.vals.to(torch.float32))
        A_sym = symmetrize_dirichlet(A32, bc_mask)
        mg = build_gmg(mesh, 1, bc_mask_np, element_fn, dtype=torch.float32,
                       device=device, nu=nu, omega=omega,
                       coarsest_max_dof=coarsest_max_dof, fine_matrix=A_sym,
                       timings=timings)
        if mg is None:
            raise ValueError("mesh does not support the geometric hierarchy")
        _sync(device)
    timings["mg_levels"] = [A.n_rows for A in mg[0].mats]

    with span("solve_s", timings):
        x0 = torch.where(bc_mask, bc_vals, 0.0)
        x, stats = cg_with_refinement(
            dia_operator(A64), dia_operator(A32), b64,
            precond32=gmg_preconditioner(*mg), rtol=rtol,
            inner_rtol=inner_rtol, max_outer=max_outer,
            inner_maxiter=inner_maxiter, x0=x0)
        _sync(device)
    timings.update(krylov_timings(stats))
    record("solve_box_poisson_1e8", timings)
    return x.cpu().numpy(), stats, timings
