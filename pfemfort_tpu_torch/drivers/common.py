# Ported from pfemfort_tpu/drivers/common.py (reduced-system Jacobi paths).
"""Shared implicit-solve pipeline: dofmap -> pattern -> assemble -> Krylov.

This is the skeleton every reference driver re-implements inline
(read files -> DOF maps -> preallocate -> assemble -> solve -> gather;
PFEMFort src/triapoissonserialimpl1.F and 14 siblings).  Three
paths, chosen from the mesh:

  * generated box-tet and rect-tria meshes whose free nodes form a box
    (ndof = 1): scatter-free structured slice-add assembly of the reduced
    DIA system;
  * every other mesh: the pattern/segment-sum assembly
    (assembly/pattern.py, assembly/assemble.py).  A structure-less mesh
    whose numbering is not DIA-able is first renumbered geometrically
    (mesh/reorder.py:recover_structure); one that stays off the DIA
    census is assembled as ELL and solved in a bandwidth-reducing row
    order through the ELL SpMV kernel.

Every SpMV goes through sparse/ops.py:operator_and_diag (kernels B1 and B2
on the card, their plain versions on the CPU); the Krylov method is
Jacobi-preconditioned CG, BiCGStab or GMRES.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pfemfort_tpu_torch.assembly import structured as st
from pfemfort_tpu_torch.assembly.assemble import (
    assemble_matrix,
    assemble_rhs,
    build_assembly_plan,
    dirichlet_rhs_correction,
)
from pfemfort_tpu_torch.assembly.pattern import AssemblyPattern, \
    build_pattern
from pfemfort_tpu_torch.dofs.dofmap import build_dofmap, full_lattice, \
    reduced_box, reduced_lattice
from pfemfort_tpu_torch.elements.geometry import to_element_minor
from pfemfort_tpu_torch.mesh.core import Mesh
from pfemfort_tpu_torch.mesh.reorder import recover_structure
from pfemfort_tpu_torch.solve.cg import SolveStats, bicgstab_solve, \
    cg_solve, jacobi_preconditioner
from pfemfort_tpu_torch.solve.gmres import gmres_solve
from pfemfort_tpu_torch.sparse.formats import ELLMatrix
from pfemfort_tpu_torch.sparse.ops import operator_and_diag
from pfemfort_tpu_torch.sparse.ordering import coord_lex_order, \
    permuted_sorted_cols, rcm_order

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


_SOLVERS = {"cg": cg_solve, "bicgstab": bicgstab_solve,
            "gmres": gmres_solve}


def _structured_box(mesh: Mesh, dofmap):
    """The free-node box of a generated box_tet or rect_tria mesh, or
    None."""
    if (mesh.structure or {}).get("kind") not in ("box_tet", "rect_tria"):
        return None
    return reduced_box(mesh, dofmap)


def build_reduced_assembler(mesh: Mesh, ndof: int, dofmap, element_fn,
                            dtype: torch.dtype, device: torch.device):
    """Return assemble(coords_em) -> (A, b_reduced).

    Generated box-tet and rect-tria meshes whose free nodes form a
    rectangular box take the scatter-FREE structured slice-add assembly of
    the FULL system and the slice-only reduction
    (assembly/structured.py:reduce_structured_system).
    Every other mesh takes the pattern path, which needs `dofmap` built
    with `with_elem=True`; its assembler carries the pattern as
    `assemble.pattern`.  Both give the same reduced system.
    """
    red_box = _structured_box(mesh, dofmap)
    if red_box is None:
        return _pattern_assembler(mesh, dofmap, element_fn, dtype, device)
    if mesh.structure["kind"] == "box_tet":
        plan = st.build_structured_plan(
            mesh.structure["nex"], mesh.structure["ney"],
            mesh.structure["nez"], ndof=ndof)
        asm_mat, asm_rhs = (st.assemble_dia_structured,
                            st.assemble_rhs_structured)
    else:
        plan = st.build_structured_plan_2d(
            mesh.structure["nex"], mesh.structure["ney"], ndof=ndof)
        asm_mat, asm_rhs = (st.assemble_dia_structured_2d,
                            st.assemble_rhs_structured_2d)
    shape = full_lattice(mesh)
    bc_vals_full = torch.as_tensor(dofmap.bc_values_full, dtype=dtype,
                                   device=device)

    n_chunks = 1
    if mesh.structure["kind"] == "box_tet" \
            and mesh.n_elem > _CHUNK_ABOVE_ELEMS:
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
            A_full = asm_mat(Ke, plan)
            b_full = asm_rhs(Fe_src, plan)
        return st.reduce_structured_system(
            A_full, b_full, red_box, shape, bc_vals_full)

    return assemble


def _pattern_assembler(mesh, dofmap, element_fn, dtype, device):
    if dofmap.elem_dof is None:
        raise ValueError("the pattern assembly needs a DOF map built with "
                         "with_elem=True")
    pattern = build_pattern(dofmap.elem_dof, dofmap.total_dof,
                            lattice=reduced_lattice(mesh, dofmap))
    plan = build_assembly_plan(pattern, device)
    ubc_e = torch.as_tensor(dofmap.bc_values_full[dofmap.elem_nodedof].T,
                            dtype=dtype, device=device)

    def assemble(coords_em):
        Ke, Fe_src = element_fn(coords_em)
        A = assemble_matrix(Ke, plan)
        b = assemble_rhs(Fe_src + dirichlet_rhs_correction(Ke, ubc_e), plan)
        return A, b

    assemble.pattern = pattern
    return assemble


def _point_loads(dofmap, force_bc) -> np.ndarray:
    """Nodal ForceBC rows -> reduced rhs vector (row-ownership guard as in
    triaelasticityparallelimpl1.F:976-987)."""
    fvec = np.zeros(dofmap.total_dof, dtype=np.float64)
    if force_bc is not None and len(force_bc):
        rows = dofmap.node_dof[force_bc[:, 0].astype(np.int64),
                               force_bc[:, 1].astype(np.int64)]
        keep = rows >= 0
        np.add.at(fvec, rows[keep], force_bc[keep, 2])
    return fvec


@dataclasses.dataclass(frozen=True)
class EllOrdering:
    """A row ordering of an ELL system, with the permuted column layout
    and the source slot of every permuted value on the device."""

    name: str              # 'lex' or 'rcm'
    order: torch.Tensor    # (N,) int64, ordered row -> original row
    inv: torch.Tensor      # (N,) int64, original row -> ordered row
    cols: torch.Tensor     # (N, K) int32, ascending per row, sentinels last
    src: torch.Tensor      # (N*K,) int64 flat slot of the original values

    def system(self, A: ELLMatrix, b: torch.Tensor
               ) -> Tuple[ELLMatrix, torch.Tensor]:
        """(A, b) in the ordered space: one gather of the values per
        assembly, never per SpMV."""
        vals = A.vals.reshape(-1)[self.src].reshape(self.cols.shape)
        return ELLMatrix(cols=self.cols, vals=vals, n_cols=A.n_cols), \
            b[self.order]


def _column_span(pattern: AssemblyPattern, order: np.ndarray) -> int:
    """Sum over rows of the span (max - min) of the row's valid columns
    once rows and columns are renumbered by `order`."""
    N = pattern.n_rows
    inv = np.empty(N, np.int64)
    inv[order] = np.arange(N)
    valid = pattern.ell_cols < N
    cols = inv[np.where(valid, pattern.ell_cols, 0)]
    hi = np.where(valid, cols, -1).max(axis=1)
    lo = np.where(valid, cols, N).min(axis=1)
    return int(np.maximum(hi - lo, 0).sum())


def build_ell_ordering(pattern: AssemblyPattern, coords_rows: np.ndarray,
                       comp: np.ndarray, device) -> EllOrdering:
    """Pick the row ordering of an ELL pattern and lay it out on `device`.

    The candidates are the geometric (z, y, x) order of the rows' nodes and
    reverse Cuthill-McKee.  The JAX package picked the one with fewer
    slot-gather virtual rows, a cost of its TPU kernel.  The ELL kernel on
    the card is served best when the rows of one thread block read x from
    a narrow window (shared cache lines), so the rule here is the smaller
    sum over rows of the column span; on a tie lex wins, since it restores
    a permuted lattice's own numbering exactly.
    """
    cands = [("lex", coord_lex_order(coords_rows, comp)),
             ("rcm", rcm_order(pattern.indptr, pattern.indices,
                               pattern.n_rows))]
    name, order = min(cands, key=lambda c: _column_span(pattern, c[1]))
    cols, src, inv = permuted_sorted_cols(pattern.ell_cols, pattern.n_rows,
                                          order, pattern.n_rows)
    device = torch.device(device)
    return EllOrdering(
        name=name,
        order=torch.as_tensor(order, device=device),
        inv=torch.as_tensor(inv, device=device),
        cols=torch.as_tensor(cols.astype(np.int32), device=device),
        src=torch.as_tensor(src.reshape(-1), device=device))


def solve_implicit(
    mesh: Mesh,
    ndof: int,
    dirichlet: np.ndarray,
    element_fn: Callable,
    force_bc: Optional[np.ndarray] = None,
    device="cpu",
    dtype: Optional[torch.dtype] = None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    method: str = "cg",
    recover: bool = True,
    precond: str = "jacobi",
) -> ImplicitResult:
    """Assemble and solve K u = F for one element kernel.

    Args:
      element_fn: coords_em (npe, ndim, E) tensor -> (Ke (ns,ns,E),
                  Fe_src (ns,E)).
      dirichlet:  (n,3) [node, dof, value] rows (0-based).
      force_bc:   optional (n,3) nodal point loads added to the rhs
                  (the reference's ForceBC files); loads on Dirichlet
                  dofs are dropped.
      method:     'cg' (the reference default, solverpetsc.F:187),
                  'bicgstab' or 'gmres'.
      device, dtype: where and in what precision assembly and solve run;
                  dtype None means torch.get_default_dtype().
      recover:    when a structure-less mesh's diagonal census fails the
                  DIA threshold, try the geometric lexicographic
                  renumbering (mesh/reorder.py) that restores the DIA
                  operator for permuted lattice meshes; the solution is
                  mapped back to the caller's numbering and
                  timings["structure_recovered"] is True.
    Timings: pattern_s (host set-up), order_s (ELL row ordering, ELL path
    only), assemble_s and solve_s (each ends in a device synchronise).
    """
    if method not in _SOLVERS:
        raise ValueError(f"method={method!r}: one of {sorted(_SOLVERS)}")
    if precond != "jacobi":
        raise NotImplementedError(
            f"precond={precond!r}: only 'jacobi' is ported; the other "
            "preconditioners wait for ROADMAP A.6")
    device = torch.device(device)
    if dtype is None:
        dtype = torch.get_default_dtype()

    if recover and mesh.structure is None:
        rec = recover_structure(mesh, ndof, dirichlet, force_bc)
        if rec is not None:
            mesh2, dbc2, fbc2, perm, dofmap0 = rec
            res = solve_implicit(
                mesh2, ndof, dbc2, element_fn, force_bc=fbc2, device=device,
                dtype=dtype,
                rtol=rtol, atol=atol, maxiter=maxiter, method=method,
                recover=False, precond=precond)
            u_full = res.u_full.reshape(mesh.n_node, ndof)[perm].reshape(-1)
            return ImplicitResult(
                u_full=u_full,
                u_reduced=torch.as_tensor(u_full[dofmap0.assy_for_soln],
                                          dtype=dtype, device=device),
                stats=res.stats,
                timings=dict(res.timings, structure_recovered=True))

    t0 = time.perf_counter()
    dofmap = build_dofmap(mesh, ndof, dirichlet, with_elem=False)
    if _structured_box(mesh, dofmap) is None:
        dofmap = build_dofmap(mesh, ndof, dirichlet)
    assemble_reduced = build_reduced_assembler(
        mesh, ndof, dofmap, element_fn, dtype, device)
    coords_em = torch.as_tensor(to_element_minor(mesh.elem_coords()),
                                dtype=dtype, device=device)
    fvec = torch.as_tensor(_point_loads(dofmap, force_bc), dtype=dtype,
                           device=device)
    _sync(device)
    timings = dict(pattern_s=time.perf_counter() - t0)

    ordering = None
    pattern = getattr(assemble_reduced, "pattern", None)
    if pattern is not None and pattern.layout == "ell":
        t0 = time.perf_counter()
        ordering = build_ell_ordering(
            pattern, mesh.coords[dofmap.assy_for_soln // ndof],
            dofmap.assy_for_soln % ndof, device)
        _sync(device)
        timings["order_s"] = time.perf_counter() - t0

    if maxiter is None:
        maxiter = max(10 * dofmap.total_dof, 1000)

    t0 = time.perf_counter()
    A, b = assemble_reduced(coords_em)
    b = b + fvec
    if ordering is not None:
        A, b = ordering.system(A, b)
    operator, diag = operator_and_diag(A)
    _sync(device)
    timings["assemble_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    u, stats = _SOLVERS[method](
        operator, b, precond=jacobi_preconditioner(diag), rtol=rtol,
        atol=atol, maxiter=maxiter)
    if ordering is not None:
        u = u[ordering.inv]
    _sync(device)
    timings["solve_s"] = time.perf_counter() - t0

    u_full = dofmap.expand_solution(u.cpu().to(torch.float64).numpy())
    return ImplicitResult(u_full=u_full, u_reduced=u, stats=stats,
                          timings=timings)
