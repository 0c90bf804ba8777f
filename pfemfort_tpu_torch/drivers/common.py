# Ported from pfemfort_tpu/drivers/common.py (single device).
"""Shared implicit-solve pipeline: dofmap -> pattern -> assemble -> Krylov.

This is the skeleton every reference driver re-implements inline
(read files -> DOF maps -> preallocate -> assemble -> solve -> gather;
PFEMFort src/triapoissonserialimpl1.F and 14 siblings).  Three
paths for the reduced (BC-eliminated) system, chosen from the mesh:

  * generated box-tet and rect-tria meshes whose free nodes form a box
    (ndof = 1): scatter-free structured slice-add assembly of the reduced
    DIA system;
  * every other mesh: the pattern/segment-sum assembly
    (assembly/pattern.py, assembly/assemble.py).  A structure-less mesh
    whose numbering is not DIA-able is first renumbered geometrically
    (mesh/reorder.py:recover_structure); one that stays off the DIA
    census is assembled as ELL and solved in a bandwidth-reducing row
    order: float32 systems through the hybrid operator
    (sparse/hybrid.py: dense diagonals on the DIA kernel, the remainder on
    the ELL kernel), float64 ones through the ELL kernel alone, as in the
    JAX package.

Every SpMV goes through sparse/ops.py:operator_and_diag (kernels B1 and B2
on the card, their plain versions on the CPU); the Krylov method is CG,
BiCGStab or GMRES, preconditioned by Jacobi, Chebyshev (solve/precond.py),
IC(0) (solve/ic0.py) or smoothed-aggregation AMG (solve/amg.py), the last
two with their products routed by solve/amg_device.py.

`solve_implicit_fullsystem` keeps every node-dof with identity Dirichlet
rows (bc_mode='full'), preconditioned by Jacobi or geometric multigrid
(solve/multigrid.py); `refine=True` solves the reduced system to a true
float64 residual with float32 inner CG (solve/refine.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pfemfort_tpu_torch.assembly import structured as st
from pfemfort_tpu_torch.assembly.fullsystem import zero_dirichlet_rows
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
from pfemfort_tpu_torch.dofs.loads import nodal_loads, \
    reduced_loads as _point_loads
from pfemfort_tpu_torch.elements.geometry import element_coords
from pfemfort_tpu_torch.mesh.core import Mesh
from pfemfort_tpu_torch.mesh.reorder import recover_structure
from pfemfort_tpu_torch.solve.amg import build_samg
from pfemfort_tpu_torch.solve.amg_device import build_ic0_device, \
    build_samg_device, ic0_device_preconditioner, permute_csr, \
    samg_device_preconditioner
from pfemfort_tpu_torch.solve.cg import SolveStats, bicgstab_solve, \
    cg_solve, jacobi_preconditioner, krylov_timings
from pfemfort_tpu_torch.solve.gmres import gmres_solve
from pfemfort_tpu_torch.solve.ic0 import _csr_from_matrix, \
    build_ic0_from_csr
from pfemfort_tpu_torch.solve.multigrid import build_gmg, \
    gmg_preconditioner
from pfemfort_tpu_torch.solve.precond import chebyshev_preconditioner
from pfemfort_tpu_torch.solve.refine import cg_with_refinement
from pfemfort_tpu_torch.sparse.formats import ELLMatrix
from pfemfort_tpu_torch.sparse.hybrid import HybridLayout, apply_hybrid, \
    hybrid_layout, split_sorted
from pfemfort_tpu_torch.sparse.ops import operator_and_diag
from pfemfort_tpu_torch.sparse.ordering import coord_lex_order, \
    permuted_sorted_cols, rcm_order
from pfemfort_tpu_torch.sparse.sliced import SliceLayout, SlicedELL, \
    ell_to_sliced, slice_ell
from pfemfort_tpu_torch.utils.device import resolve_device, \
    synchronize as _sync
from pfemfort_tpu_torch.utils.timing import record, span


class ImplicitResult(NamedTuple):
    u_full: np.ndarray          # (n_node*ndof,) solution incl. BC values
    u_reduced: torch.Tensor     # (total_dof,) solution on the device
    stats: SolveStats
    timings: dict
    # (n_elem,) rank that assembled each element (sharded solves)
    elem_part: Optional[np.ndarray] = None


_SOLVERS = {"cg": cg_solve, "bicgstab": bicgstab_solve,
            "gmres": gmres_solve}


def _structured_box(mesh: Mesh, dofmap):
    """The free-node box of a generated box_tet or rect_tria mesh, or
    None."""
    if (mesh.structure or {}).get("kind") not in ("box_tet", "rect_tria"):
        return None
    return reduced_box(mesh, dofmap)


def build_reduced_assembler(mesh: Mesh, ndof: int, dofmap, element_fn,
                            dtype: torch.dtype, device: torch.device,
                            timings: Optional[dict] = None):
    """Return assemble(coords_em) -> (A, b_reduced).

    Generated box-tet and rect-tria meshes whose free nodes form a
    rectangular box take the scatter-FREE structured slice-add assembly of
    the FULL system and the slice-only reduction
    (assembly/structured.py:reduce_structured_system).
    Every other mesh takes the pattern path, which needs `dofmap` built
    with `with_elem=True`; its assembler carries the pattern as
    `assemble.pattern`.  Both give the same reduced system.  A box_tet mesh
    of more than st.CHUNK_ABOVE_ELEMS elements is assembled in
    `assemble.n_chunks` z-slab chunks.  `timings`: where the pattern
    path's spans pattern.census_s and pattern.plan_s go.
    """
    red_box = _structured_box(mesh, dofmap)
    if red_box is None:
        return _pattern_assembler(mesh, dofmap, element_fn, dtype, device,
                                  timings)
    plan, asm_mat, asm_rhs = st.structured_plan(mesh, ndof)
    shape = full_lattice(mesh)
    bc_vals_full = torch.as_tensor(dofmap.bc_values_full, dtype=dtype,
                                   device=device)

    n_chunks = 1
    if mesh.structure["kind"] == "box_tet":
        n_chunks = st.chunk_count(mesh.structure["nez"], mesh.n_elem)

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

    assemble.n_chunks = n_chunks
    return assemble


def _pattern_assembler(mesh, dofmap, element_fn, dtype, device, timings):
    if dofmap.elem_dof is None:
        raise ValueError("the pattern assembly needs a DOF map built with "
                         "with_elem=True")
    with span("pattern.census_s", timings):
        pattern = build_pattern(dofmap.elem_dof, dofmap.total_dof,
                                lattice=reduced_lattice(mesh, dofmap))
    with span("pattern.plan_s", timings):
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


@dataclasses.dataclass(frozen=True)
class EllOrdering:
    """A row ordering of an ELL system on the device: the ordered pattern
    in kernel B2's sliced layout (sparse/sliced.py), each sliced slot
    sourced from the original (N, K) values, and the hybrid split of the
    ordered pattern when one was asked for."""

    name: str              # 'lex' or 'rcm'
    order: torch.Tensor    # (N,) int64, ordered row -> original row
    inv: torch.Tensor      # (N,) int64, original row -> ordered row
    layout: SliceLayout    # ordered, sliced; src indexes the original values
    hybrid: Optional[HybridLayout] = None
    hybrid_stats: Optional[dict] = None   # diagonals, nnz_dia, nnz_rem, k_rem

    def system(self, A: ELLMatrix, b: torch.Tensor
               ) -> Tuple[SlicedELL, torch.Tensor]:
        """(A, b) in the ordered space, A sliced: one gather of the values
        per assembly, never per SpMV."""
        return self.layout.pack(A.vals), b[self.order]


def _order_costs(pattern: AssemblyPattern, order: np.ndarray,
                 fill: float = 0.2) -> Tuple[int, int]:
    """(entries off the dense diagonals, sum of row column spans) once rows
    and columns are renumbered by `order`.  A diagonal is dense when at
    least `fill` of the rows populate it (the JAX package's hybrid
    threshold, sparse/hybrid.py)."""
    N = pattern.n_rows
    inv = np.empty(N, np.int64)
    inv[order] = np.arange(N)
    valid = pattern.ell_cols < N
    cols = inv[np.where(valid, pattern.ell_cols, 0)]
    offs = (cols - inv[:, None])[valid]
    cnt = np.bincount(offs + N, minlength=2 * N)
    off_dense = int(cnt[cnt < max(int(fill * N), 1)].sum())
    hi = np.where(valid, cols, -1).max(axis=1)
    lo = np.where(valid, cols, N).min(axis=1)
    return off_dense, int(np.maximum(hi - lo, 0).sum())


def build_ell_ordering(pattern: AssemblyPattern, coords_rows: np.ndarray,
                       comp: np.ndarray, device,
                       hybrid: bool = False) -> EllOrdering:
    """Pick the row ordering of an ELL pattern and lay it out on `device`;
    `hybrid`: also split the ordered pattern into dense diagonals and an ELL
    remainder (sparse/hybrid.py), in the chosen order.

    The candidates are the geometric (z, y, x) order of the rows' nodes and
    reverse Cuthill-McKee.  The JAX package's TPU path took the one whose
    DIA + slot-gather split left the least work off the dense diagonals,
    which is lex on every near-lattice mesh (it restores a permuted
    lattice's own numbering).  The rule here keeps that first criterion,
    the count of entries off the dense diagonals, without the TPU kernel's
    cost constants; on a tie the smaller sum over rows of the column span
    wins (the ELL kernel is served best when the rows of one thread block
    read x from a narrow window), then lex.  The row order matters beyond
    the SpMV: IC(0) and SA-AMG are set up in this row space, and their
    quality depends on it (ROADMAP C).
    """
    cands = [("lex", coord_lex_order(coords_rows, comp)),
             ("rcm", rcm_order(pattern.indptr, pattern.indices,
                               pattern.n_rows))]
    name, order = min(cands, key=lambda c: _order_costs(pattern, c[1]))
    cols, src, inv = permuted_sorted_cols(pattern.ell_cols, pattern.n_rows,
                                          order, pattern.n_rows)
    device = torch.device(device)
    split = stats = None
    if hybrid:
        plan = split_sorted(cols, src, pattern.n_rows)
        split = hybrid_layout(plan, device)
        stats = dict(diagonals=plan.D, nnz_dia=plan.nnz_dia,
                     nnz_rem=plan.nnz_rem, k_rem=plan.k_rem)
    layout = slice_ell(torch.as_tensor(cols.astype(np.int32), device=device),
                       pattern.n_rows)
    return EllOrdering(
        name=name,
        order=torch.as_tensor(order, device=device),
        inv=torch.as_tensor(inv, device=device),
        layout=layout.compose(torch.as_tensor(src, device=device)),
        hybrid=split, hybrid_stats=stats)


_PRECONDS = ("jacobi", "cheby", "ic0", "amg", "mg")


def _solve_row_csr(A, pattern, ordering):
    """The assembled matrix as a host CSR in the solve's row space (the
    EllOrdering's on the ELL path)."""
    indptr, indices, vals, n = _csr_from_matrix(A, pattern)
    if ordering is not None:
        indptr, indices, vals = permute_csr(indptr, indices, vals,
                                            ordering.order.cpu().numpy())
    return indptr, indices, vals, n


def _host_preconditioner(precond, A, pattern, ordering, operator, ndof,
                         dtype, device, timings):
    """IC(0) or SA-AMG built from the assembled values on the host, in the
    solve's row space.  Returns the preconditioner, or None when SA-AMG
    cannot coarsen this system; and the hierarchy's level sizes (AMG) for
    the timings.  IC(0)'s set-up times itself into `timings` with child
    spans of ic0_setup_s: ic0.csr_s (the values to the host and the CSR),
    ic0.factor_s and ic0.layout_s (solve/ic0.py:build_ic0_from_csr; the
    latter also routes T and T^T and copies them to `device`), and the
    counters ic0.t_nnz and ic0.route."""
    if precond == "ic0":
        with span("ic0.csr_s", timings):
            csr = _solve_row_csr(A, pattern, ordering)
        # staged on the host: build_ic0_device lays the blocks out on
        # `device` in their routed forms
        arrs = build_ic0_from_csr(*csr, dtype=dtype, device="cpu",
                                  timings=timings)
        with span("ic0.layout_s", timings):
            dev = build_ic0_device(arrs, dtype=dtype, device=device,
                                   timings=timings)
        return ic0_device_preconditioner(dev), None
    built = build_samg(*_solve_row_csr(A, pattern, ordering), ndof=ndof,
                       dtype=dtype, device="cpu")
    if built is None:
        return None, None
    arrs, meta = built
    dev = build_samg_device(arrs, meta.sizes, dtype=dtype, device=device,
                            external_fine_op=True)
    return samg_device_preconditioner(dev, meta, operator), list(meta.sizes)


def solve_implicit(
    mesh: Mesh,
    ndof: int,
    dirichlet: np.ndarray,
    element_fn: Callable,
    force_bc: Optional[np.ndarray] = None,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    method: str = "cg",
    refine: bool = False,
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
      refine:     mixed-precision iterative refinement: float32 inner CG
                  (Jacobi) with a float64 residual loop reaching rtol in
                  the TRUE float64 residual (solve/refine.py).  Ignores
                  dtype, method and precond, and skips recovery.
      recover:    when a structure-less mesh's diagonal census fails the
                  DIA threshold, try the geometric lexicographic
                  renumbering (mesh/reorder.py) that restores the DIA
                  operator for permuted lattice meshes; the solution is
                  mapped back to the caller's numbering and
                  timings["structure_recovered"] is True.
      precond:    'jacobi'; 'cheby' (Chebyshev polynomial of D^-1 A
                  around the solve's own operator); 'ic0' or 'amg' (set up
                  on the host from the assembled values, in the solve's row
                  space; 'amg' falls back to Jacobi when the system cannot
                  be coarsened); 'mg' is the full system's
                  (solve_implicit_fullsystem) and gives Jacobi here.
                  For any of them but 'jacobi', timings["precond_used"]
                  says which one ran.
    stats.converged is the Krylov loop's verdict held to the answer's own
    residual: an answer whose b - A u is larger than b, worse than the
    zero start (as float32 CG of a slender beam to rtol 1e-8 can leave it),
    is reported unconverged (_held_to_its_residual).
    Timings: pattern_s (host set-up), order_s and ordering (ELL row
    ordering and its name, ELL path only; float32 adds the hybrid split's
    hybrid_diagonals, hybrid_nnz_dia, hybrid_nnz_rem, hybrid_k_rem),
    assemble_s, ic0_setup_s /
    amg_setup_s (host set-up of those preconditioners) and solve_s (each
    ends in a device synchronise); amg_levels (rows per AMG level) and
    assembly_chunks (when the structured assembly runs in z-slabs) where
    they apply; refine=True adds outer_iters.  Inside pattern_s, spans
    without a synchronise of their own (utils/timing.py:span):
    pattern.dofmap_s (both DOF maps), pattern.census_s (build_pattern:
    the offset census, the rhs destinations, the ELL layout; pattern path
    only), pattern.plan_s (the assembly plan and the Dirichlet values per
    element slot; pattern path only) and pattern.coords_s (the element
    coordinates and point loads, copied to the device).  From the Krylov
    loop (solve/cg.py; summed over the inner solves with refine=True, none
    for GMRES): krylov.loop_s, krylov.wait_s and krylov.host_reads.
    """
    if method not in _SOLVERS:
        raise ValueError(f"method={method!r}: one of {sorted(_SOLVERS)}")
    if precond not in _PRECONDS:
        raise ValueError(f"precond={precond!r}: one of {list(_PRECONDS)}")
    device = resolve_device(device)
    if dtype is None:
        dtype = torch.get_default_dtype()

    if recover and mesh.structure is None and not refine:
        rec = recover_structure(mesh, ndof, dirichlet, force_bc)
        if rec is not None:
            mesh2, dbc2, fbc2, perm, dofmap0 = rec
            res = solve_implicit(
                mesh2, ndof, dbc2, element_fn, force_bc=fbc2, device=device,
                dtype=dtype,
                rtol=rtol, atol=atol, maxiter=maxiter, method=method,
                recover=False, precond=precond)
            u_full = res.u_full.reshape(mesh.n_node, ndof)[perm].reshape(-1)
            # the inner call's record (RECENT) holds this same dict
            res.timings["structure_recovered"] = True
            return ImplicitResult(
                u_full=u_full,
                u_reduced=torch.as_tensor(u_full[dofmap0.assy_for_soln],
                                          dtype=dtype, device=device),
                stats=res.stats, timings=res.timings)
    if refine:
        return _solve_implicit_refined(mesh, ndof, dirichlet, element_fn,
                                       force_bc=force_bc, device=device,
                                       rtol=rtol, maxiter=maxiter)

    timings = {}
    with span("pattern_s", timings):
        dofmap, assemble_reduced, coords_em, fvec = _reduced_setup(
            mesh, ndof, dirichlet, element_fn, force_bc, dtype, device,
            timings)

    ordering = None
    pattern = getattr(assemble_reduced, "pattern", None)
    if pattern is not None and pattern.layout == "ell":
        with span("order_s", timings):
            # float32 ELL systems go through the hybrid operator, as in the
            # JAX package (drivers/common.py there); float64 ones stay on B2
            ordering = build_ell_ordering(
                pattern, mesh.coords[dofmap.assy_for_soln // ndof],
                dofmap.assy_for_soln % ndof, device,
                hybrid=dtype == torch.float32)
            _sync(device)
        timings["ordering"] = ordering.name
        if ordering.hybrid is not None:
            timings.update({f"hybrid_{k}": v
                            for k, v in ordering.hybrid_stats.items()})

    if maxiter is None:
        maxiter = max(10 * dofmap.total_dof, 1000)

    with span("assemble_s", timings):
        A0, b = assemble_reduced(coords_em)
        b = b + fvec
        if ordering is None:
            operator, diag = operator_and_diag(A0)
        elif ordering.hybrid is not None:
            H = ordering.hybrid.pack(A0.vals)
            b = b[ordering.order]
            operator, diag = (lambda x: apply_hybrid(H, x)), H.diagonal()
        else:
            A, b = ordering.system(A0, b)
            operator, diag = operator_and_diag(A)
        _sync(device)

    used = precond
    pc = None
    if precond in ("ic0", "amg"):
        with span(f"{precond}_setup_s", timings):
            pc, levels = _host_preconditioner(precond, A0, pattern, ordering,
                                              operator, ndof, dtype, device,
                                              timings)
            _sync(device)
        if levels is not None:
            timings["amg_levels"] = levels
    elif precond == "cheby":
        pc = chebyshev_preconditioner(operator, diag)
    if pc is None:
        used = "jacobi"
        pc = jacobi_preconditioner(diag)

    with span("solve_s", timings):
        u, stats = _SOLVERS[method](operator, b, precond=pc, rtol=rtol,
                                    atol=atol, maxiter=maxiter)
        stats = _held_to_its_residual(stats, operator, b, u)
        if ordering is not None:
            u = u[ordering.inv]
        _sync(device)
    timings.update(krylov_timings(stats))
    if precond != "jacobi":
        timings.update(precond_requested=precond, precond_used=used)

    u_full = dofmap.expand_solution(u.cpu().to(torch.float64).numpy())
    record("solve_implicit", timings)
    return ImplicitResult(u_full=u_full, u_reduced=u, stats=stats,
                          timings=timings)


def _held_to_its_residual(stats: SolveStats, operator, b,
                          u) -> SolveStats:
    """`stats`, reported unconverged when the answer's residual b - A u,
    formed once in the working precision, is larger than b, the residual
    of the zero vector the Krylov loops start from.  The loops
    judge convergence by their recurrence residual, which can meet the
    tolerance while the answer drifts away from it: float32 CG of the
    4.5M-element beam to rtol 1e-8 ended at a true residual 16 to 23 times
    b's, with Jacobi and with IC(0).  An answer between the tolerance and
    b is left as the loop reports it (a float32 solve of a stiff system
    stops at float32's own floor, 6e-3 on the 64^3 elasticity box)."""
    if not stats.converged:
        return stats
    rnorm = torch.linalg.vector_norm(b - operator(u))
    if bool(rnorm <= torch.linalg.vector_norm(b)):
        return stats
    return stats._replace(converged=False)


def _reduced_setup(mesh: Mesh, ndof: int, dirichlet: np.ndarray,
                   element_fn: Callable, force_bc: Optional[np.ndarray],
                   dtype: torch.dtype, device: torch.device, timings: dict):
    """(dofmap, assemble, coords_em, fvec) of the reduced system, inside the
    caller's pattern_s: the DOF map (pattern.dofmap_s), the assembler, the
    coordinates and point loads on `device` (pattern.coords_s), a device
    synchronise; assembly_chunks when the assembly is chunked."""
    with span("pattern.dofmap_s", timings):
        dofmap = build_dofmap(mesh, ndof, dirichlet, with_elem=False)
        if _structured_box(mesh, dofmap) is None:
            dofmap = build_dofmap(mesh, ndof, dirichlet)
    assemble = build_reduced_assembler(mesh, ndof, dofmap, element_fn, dtype,
                                       device, timings)
    with span("pattern.coords_s", timings):
        coords_em = element_coords(mesh, dtype, device)
        fvec = torch.as_tensor(_point_loads(dofmap, force_bc), dtype=dtype,
                               device=device)
    _sync(device)
    if getattr(assemble, "n_chunks", 1) > 1:
        timings["assembly_chunks"] = assemble.n_chunks
    return dofmap, assemble, coords_em, fvec


def solve_implicit_fullsystem(
    mesh: Mesh,
    ndof: int,
    dirichlet: np.ndarray,
    element_fn: Callable,
    force_bc: Optional[np.ndarray] = None,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
    rtol: float = 1e-8,
    maxiter: Optional[int] = None,
    method: str = "cg",
    precond: str = "jacobi",
) -> ImplicitResult:
    """serialimpl3-parity path: full-size DOF system + MatZeroRows BCs
    (PFEMFort src/triapoissonserialimpl3.F:351-359, 557-558).

    No reduced renumbering: generated box_tet and rect_tria meshes (ndof <=
    3) keep their lattice and take the structured slice-add assembly; every
    other mesh takes the pattern assembly of all node-dofs.  The solve
    starts from x0 = the BC values, so the BC components of the residual
    vanish (the property that lets the reference run CG on this mildly
    nonsymmetric system).

    precond: 'jacobi' or 'mg' (geometric multigrid V-cycle on structured
    lattices, solve/multigrid.py; falls back to Jacobi on other meshes).
    Any other name gives Jacobi, as in the JAX package.
    Timings: pattern_s, assemble_s, solve_s (each ends in a device
    synchronise); precond_requested and precond_used (which one ran);
    with 'mg', mg_setup_s (the hierarchy's build; inside it mg.coarsen_s,
    the host coarsening chain) and mg_levels (rows per level); the Krylov
    loop's krylov.loop_s, krylov.wait_s and krylov.host_reads
    (solve/cg.py; none for GMRES).
    """
    if method not in _SOLVERS:
        raise ValueError(f"method={method!r}: one of {sorted(_SOLVERS)}")
    device = resolve_device(device)
    if dtype is None:
        dtype = torch.get_default_dtype()
    n_full = mesh.n_node * ndof
    timings = {}
    with span("pattern_s", timings):
        kind = (mesh.structure or {}).get("kind")
        structured = kind in ("box_tet", "rect_tria") and ndof <= 3
        dofmap = build_dofmap(mesh, ndof, dirichlet,
                              with_elem=not structured)
        if structured:
            plan, asm_mat, asm_rhs = st.structured_plan(mesh, ndof)
        else:
            # full system: every element slot keeps its global node-dof row
            plan = build_assembly_plan(
                build_pattern(dofmap.elem_nodedof, n_full), device)
            asm_mat, asm_rhs = assemble_matrix, assemble_rhs

        coords_em = element_coords(mesh, dtype, device)
        bc_mask_np = ~dofmap.free_mask_full()
        bc_mask = torch.as_tensor(bc_mask_np, device=device)
        bc_vals = torch.as_tensor(dofmap.bc_values_full, dtype=dtype,
                                  device=device)
        fvec = torch.as_tensor(nodal_loads(force_bc, mesh.n_node, ndof),
                               dtype=dtype, device=device)
        _sync(device)

    if maxiter is None:
        maxiter = max(10 * n_full, 1000)

    mg = None
    if precond == "mg" and structured:
        with span("mg_setup_s", timings):
            mg = build_gmg(mesh, ndof, bc_mask_np, element_fn, dtype=dtype,
                           device=device, timings=timings)
            _sync(device)
        if mg is not None:
            timings["mg_levels"] = [A.n_rows for A in mg[0].mats]

    with span("assemble_s", timings):
        Ke, Fe_src = element_fn(coords_em)
        A = asm_mat(Ke, plan)
        b = asm_rhs(Fe_src, plan) + fvec
        del Ke, Fe_src
        A, b = zero_dirichlet_rows(A, b, bc_mask, bc_vals)
        operator, diag = operator_and_diag(A)
        _sync(device)

    if mg is not None:
        pc, used = gmg_preconditioner(*mg), "mg"
    else:
        pc, used = jacobi_preconditioner(diag), "jacobi"
    with span("solve_s", timings):
        # start from the BC values so BC residual components vanish
        x0 = torch.where(bc_mask, bc_vals, 0.0)
        u, stats = _SOLVERS[method](operator, b, x0=x0, precond=pc,
                                    rtol=rtol, maxiter=maxiter)
        _sync(device)
    timings.update(krylov_timings(stats))
    timings.update(precond_requested=precond, precond_used=used)

    record("solve_implicit_fullsystem", timings)
    return ImplicitResult(u_full=u.cpu().to(torch.float64).numpy(),
                          u_reduced=u, stats=stats, timings=timings)


def _solve_implicit_refined(mesh, ndof, dirichlet, element_fn, force_bc,
                            device, rtol, maxiter) -> ImplicitResult:
    """Mixed-precision path to the reference's f64 1e-8 target.

    The float64 reduced system is assembled once on the device (float64 is
    native on the card); its float32 cast serves the inner Jacobi-CG.  Both
    operators go through kernel B1 (DIA) or B2 (ELL, in the pattern's own
    row order, as in the JAX package), so the outer residual is the TRUE
    float64 one."""
    f64 = torch.float64
    timings = {}
    with span("pattern_s", timings):
        dofmap, assemble64, coords64, fvec = _reduced_setup(
            mesh, ndof, dirichlet, element_fn, force_bc, f64, device,
            timings)

    if maxiter is None:
        maxiter = max(10 * dofmap.total_dof, 1000)

    with span("assemble_s", timings):
        A64, b64 = assemble64(coords64)
        del coords64
        b64 = b64 + fvec
        if isinstance(A64, ELLMatrix):     # laid out once, for both precisions
            A64 = ell_to_sliced(A64)
        A32 = dataclasses.replace(A64, vals=A64.vals.to(torch.float32))
        op64, _ = operator_and_diag(A64)
        op32, diag32 = operator_and_diag(A32)
        _sync(device)

    with span("solve_s", timings):
        x64, rstats = cg_with_refinement(
            op64, op32, b64, precond32=jacobi_preconditioner(diag32),
            rtol=rtol, inner_maxiter=maxiter)
        _sync(device)
    timings["outer_iters"] = rstats.outer_iters
    timings.update(krylov_timings(rstats))

    stats = SolveStats(iters=rstats.total_inner_iters, relres=rstats.relres,
                       converged=rstats.converged, loop_s=rstats.loop_s,
                       wait_s=rstats.wait_s, host_reads=rstats.host_reads)
    u_full = dofmap.expand_solution(x64.cpu().numpy())
    record("solve_implicit_refined", timings)
    return ImplicitResult(u_full=u_full, u_reduced=x64, stats=stats,
                          timings=timings)
