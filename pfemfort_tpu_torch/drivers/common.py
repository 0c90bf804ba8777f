# Ported from pfemfort_tpu/drivers/common.py (box-tet DIA/Jacobi/CG branch).
"""Shared implicit-solve pipeline: dofmap -> assemble -> Krylov.

This is the skeleton every reference driver re-implements inline
(read files -> DOF maps -> preallocate -> assemble -> solve -> gather;
/root/reference/src/triapoissonserialimpl1.F and 14 siblings).  The port
carries the generated box-tet branch: scatter-free structured assembly of
the reduced system, the DIA operator and Jacobi-preconditioned CG.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from pfemfort_tpu_torch.assembly import structured as st
from pfemfort_tpu_torch.dofs.dofmap import build_dofmap, full_lattice, \
    reduced_box
from pfemfort_tpu_torch.elements.geometry import to_element_minor
from pfemfort_tpu_torch.mesh.core import Mesh
from pfemfort_tpu_torch.solve.cg import SolveStats, cg_solve, \
    jacobi_preconditioner
from pfemfort_tpu_torch.sparse.ops import operator_and_diag

# Above this many elements the one-shot Ke + geometry temporaries are
# assembled in z-slab chunks.  The threshold was sized for a 16 GB TPU v5e
# (21 GB needed at 48M elements); it is still to be measured on the card.
_CHUNK_ABOVE_ELEMS = 12_000_000
_CHUNK_ELEMS = 6_000_000


class ImplicitResult(NamedTuple):
    u_full: np.ndarray          # (n_node*ndof,) solution incl. BC values
    u_reduced: torch.Tensor     # (total_dof,) solution on the device
    stats: SolveStats
    timings: dict


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_reduced_assembler(mesh: Mesh, ndof: int, dofmap, element_fn,
                            dtype: torch.dtype, device: torch.device):
    """Return assemble(coords_em) -> (A, b_reduced).

    Generated box-tet meshes whose free nodes form a rectangular box take
    the scatter-FREE structured slice-add assembly of the FULL system and
    the slice-only reduction (assembly/structured.py:reduce_structured_system).
    """
    kind = (mesh.structure or {}).get("kind")
    red_box = reduced_box(mesh, dofmap) if kind == "box_tet" else None
    if red_box is None:
        raise NotImplementedError(
            "only generated box_tet meshes whose free nodes form a box are "
            "ported; other meshes take the pattern/segment-sum assembly "
            "(ROADMAP A.1) or the recovered-structure and ELL paths "
            "(ROADMAP A.4)")
    plan = st.build_structured_plan(
        mesh.structure["nex"], mesh.structure["ney"], mesh.structure["nez"],
        ndof=ndof)
    shape = full_lattice(mesh)
    bc_vals_full = torch.as_tensor(dofmap.bc_values_full, dtype=dtype,
                                   device=device)

    n_chunks = 1
    if mesh.n_elem > _CHUNK_ABOVE_ELEMS:
        nez = mesh.structure["nez"]
        want = -(-mesh.n_elem // _CHUNK_ELEMS)
        for cand in range(want, nez + 1):
            if nez % cand == 0:
                n_chunks = cand
                break

    def assemble(coords_em):
        if n_chunks > 1:
            A_full, b_full = st.assemble_structured_chunked(
                element_fn, coords_em, plan, n_chunks)
        else:
            Ke, Fe_src = element_fn(coords_em)
            A_full = st.assemble_dia_structured(Ke, plan)
            b_full = st.assemble_rhs_structured(Fe_src, plan)
        return st.reduce_structured_system(
            A_full, b_full, red_box, shape, bc_vals_full)

    return assemble


def solve_implicit(
    mesh: Mesh,
    ndof: int,
    dirichlet: np.ndarray,
    element_fn: Callable,
    device="cpu",
    dtype: Optional[torch.dtype] = None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    method: str = "cg",
    precond: str = "jacobi",
) -> ImplicitResult:
    """Assemble and solve K u = F for one element kernel.

    Args:
      element_fn: coords_em (npe, ndim, E) tensor -> (Ke (ns,ns,E),
                  Fe_src (ns,E)).
      dirichlet:  (n,3) [node, dof, value] rows (0-based).
      device, dtype: where and in what precision assembly and solve run;
                  dtype None means torch.get_default_dtype().
    Timings: pattern_s (host set-up), assemble_s and solve_s (each ends in
    a device synchronise).
    """
    if method != "cg":
        raise NotImplementedError(
            f"method={method!r}: only 'cg' is ported; BiCGStab and GMRES "
            "wait for ROADMAP A.3")
    if precond != "jacobi":
        raise NotImplementedError(
            f"precond={precond!r}: only 'jacobi' is ported; the other "
            "preconditioners wait for ROADMAP A.6")
    device = torch.device(device)
    if dtype is None:
        dtype = torch.get_default_dtype()

    t0 = time.perf_counter()
    dofmap = build_dofmap(mesh, ndof, dirichlet, with_elem=False)
    assemble_reduced = build_reduced_assembler(
        mesh, ndof, dofmap, element_fn, dtype, device)
    coords_em = torch.as_tensor(to_element_minor(mesh.elem_coords()),
                                dtype=dtype, device=device)
    _sync(device)
    t_pattern = time.perf_counter() - t0

    if maxiter is None:
        maxiter = max(10 * dofmap.total_dof, 1000)

    t1 = time.perf_counter()
    A, b = assemble_reduced(coords_em)
    operator, diag = operator_and_diag(A)
    _sync(device)
    t_assemble = time.perf_counter() - t1

    t2 = time.perf_counter()
    u, stats = cg_solve(operator, b, precond=jacobi_preconditioner(diag),
                        rtol=rtol, atol=atol, maxiter=maxiter)
    _sync(device)
    t_solve = time.perf_counter() - t2

    u_full = dofmap.expand_solution(u.cpu().to(torch.float64).numpy())
    return ImplicitResult(
        u_full=u_full,
        u_reduced=u,
        stats=stats,
        timings=dict(pattern_s=t_pattern, assemble_s=t_assemble,
                     solve_s=t_solve),
    )
