# Ported from pfemfort_tpu/solve/multigrid.py.
"""Geometric multigrid preconditioner for structured lattice systems.

The reference exposes PC=hypre (algebraic multigrid) through its PETSc
options file (PFEMFort src/solverpetsc.F:1-8, 206-209) as the scalable
alternative to block-Jacobi.  For the generated benchmark meshes (box tets /
rect trias on a node lattice, mesh/generate.py) the equivalent is GEOMETRIC
multigrid, every component a dense lattice operation:

  * level operators: DIA matrices from the structured slice-add assembly
    (assembly/structured.py), with Dirichlet rows AND columns symmetrized to
    identity so the V-cycle stays SPD on the free subspace; applied through
    sparse/ops.py:dia_operator (kernel B1 on the card), built once per
    preconditioner, outside the Krylov loop;
  * smoother: damped Jacobi (elementwise);
  * transfers: axis-separable linear interpolation and its exact adjoint
    (strided slices and adds, no gathers);
  * coarsest level: a dense inverse computed in float64 on the host and
    applied as one small matmul (or a Chebyshev polynomial when the
    coarsening chain stalls on an odd dimension).

Used as the preconditioner of the full-size node-dof system
(assembly/fullsystem.py), where the BC components of the residual are zero
every iteration, so masking Dirichlet entries keeps the cycle linear and
symmetric.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pfemfort_tpu_torch.dofs.dofmap import full_lattice
from pfemfort_tpu_torch.elements.geometry import affine_box_bounds, \
    box_element_coords
from pfemfort_tpu_torch.mesh.core import Mesh
from pfemfort_tpu_torch.sparse.dia import DIAMatrix, dia_diagonal
from pfemfort_tpu_torch.utils.timing import span


# ---------------------------------------------------------------------------
# transfers: separable linear interpolation on a node lattice
# ---------------------------------------------------------------------------

def interp_axis(u: torch.Tensor, axis: int) -> torch.Tensor:
    """(..., nc, ...) -> (..., 2*nc-1, ...): even = copy, odd = midpoint."""
    u = u.movedim(axis, -1)
    mid = 0.5 * (u[..., :-1] + u[..., 1:])
    pairs = torch.stack([u[..., :-1], mid], dim=-1)
    pairs = pairs.reshape(*u.shape[:-1], 2 * (u.shape[-1] - 1))
    out = torch.cat([pairs, u[..., -1:]], dim=-1)
    return out.movedim(-1, axis)


def restrict_axis(f: torch.Tensor, axis: int) -> torch.Tensor:
    """Exact adjoint of `interp_axis`: c[i] = f[2i] + (f[2i-1]+f[2i+1])/2."""
    f = f.movedim(axis, -1)
    ev = f[..., 0::2]
    od = f[..., 1::2]
    zero = od.new_zeros(*od.shape[:-1], 1)
    c = ev + 0.5 * (torch.cat([od, zero], dim=-1)
                    + torch.cat([zero, od], dim=-1))
    return c.movedim(-1, axis)


def prolong(ec: torch.Tensor, coarse_shape: Tuple[int, ...],
            ndof: int) -> torch.Tensor:
    """Coarse flat vector -> fine flat vector (tri/bi-linear)."""
    u = ec.reshape(*coarse_shape, ndof)
    for ax in range(len(coarse_shape)):
        u = interp_axis(u, ax)
    return u.reshape(-1)


def restrict(rf: torch.Tensor, fine_shape: Tuple[int, ...],
             ndof: int) -> torch.Tensor:
    """Fine flat residual -> coarse flat residual (adjoint of `prolong`)."""
    u = rf.reshape(*fine_shape, ndof)
    for ax in range(len(fine_shape)):
        u = restrict_axis(u, ax)
    return u.reshape(-1)


# ---------------------------------------------------------------------------
# level construction
# ---------------------------------------------------------------------------

class GMGArrays(NamedTuple):
    """Per-level device data.

    mats[l] has Dirichlet rows AND columns set to identity (the symmetric
    variant of fullsystem.zero_dirichlet_rows), masks[l] is 1.0 on free
    node-dofs and 0.0 on Dirichlet ones, coarse_inv is the dense inverse of
    the coarsest symmetrized operator ((1, 1) zeros under a Chebyshev coarse
    solve).
    """
    mats: Tuple[DIAMatrix, ...]
    inv_diags: Tuple[torch.Tensor, ...]
    masks: Tuple[torch.Tensor, ...]
    coarse_inv: torch.Tensor


@dataclasses.dataclass(frozen=True)
class GMGMeta:
    """Static cycle metadata."""
    shapes: Tuple[Tuple[int, ...], ...]   # node-lattice shape per level
    ndof: int
    nu: int          # pre/post smoothing sweeps (equal -> symmetric cycle)
    omega: float     # Jacobi damping
    # (lmax, lmin, degree) of a Chebyshev coarse solve when the coarsening
    # chain sticks on an odd dimension above the dense-inverse cap (e.g.
    # 200 -> 100 -> 50 -> 25 stalls at 17.6k dofs); a fixed polynomial of
    # the Jacobi-scaled coarse operator is linear and SPD, so CG stays valid
    coarse_cheby: Optional[Tuple[float, float, int]] = None


def symmetrize_dirichlet(A: DIAMatrix, bc_mask: torch.Tensor) -> DIAMatrix:
    """Identity Dirichlet rows and columns (keeps the operator SPD).

    bc_mask: (n,) bool on A's device.  The column mask of offset o is the
    row mask shifted by o (False outside [0, n)), one slice of a padded
    mask per diagonal."""
    n = A.n_rows
    neg = max(0, -min(A.offsets))
    pos = max(0, max(A.offsets))
    padded = torch.cat([bc_mask.new_zeros(neg), bc_mask,
                        bc_mask.new_zeros(pos)])
    new_vals = []
    for d, o in enumerate(A.offsets):
        if o == 0:
            new_vals.append(torch.where(bc_mask, 1.0, A.vals[d]))
        else:
            col_bc = padded[neg + o:neg + o + n]
            new_vals.append(torch.where(bc_mask | col_bc, 0.0, A.vals[d]))
    return dataclasses.replace(A, vals=torch.stack(new_vals))


def _coarse_box_mesh(mesh: Mesh) -> Tuple[Mesh, dict]:
    """Halve a structured mesh by subsampling its node lattice."""
    from pfemfort_tpu_torch.mesh import generate as gen

    st = dict(mesh.structure)
    kind = st["kind"]
    if kind == "box_tet":
        nex, ney, nez = st["nex"] // 2, st["ney"] // 2, st["nez"] // 2
        shape = (st["nez"] + 1, st["ney"] + 1, st["nex"] + 1)
        coords = mesh.coords.reshape(*shape, 3)[::2, ::2, ::2].reshape(-1, 3)
        cm, _ = gen.box_tet(0, 1, nex, 0, 1, ney, 0, 1, nez)
        coarse = Mesh("tetra4", coords, cm.conn,
                      structure=dict(kind=kind, nex=nex, ney=ney, nez=nez))
    elif kind == "rect_tria":
        nex, ney = st["nex"] // 2, st["ney"] // 2
        shape = (st["ney"] + 1, st["nex"] + 1)
        coords = mesh.coords.reshape(*shape, 2)[::2, ::2].reshape(-1, 2)
        cm = gen.rect_tria(0, 1, nex, 0, 1, ney)
        coarse = Mesh("tria3", coords, cm.conn,
                      structure=dict(kind=kind, nex=nex, ney=ney))
    else:
        raise ValueError(f"unsupported structure kind {kind!r}")
    return coarse, coarse.structure


def _assemble_level(mesh: Mesh, ndof: int, element_fn: Callable, dtype,
                    device, bc_mask: torch.Tensor) -> DIAMatrix:
    """Element matrices -> structured slice-add assembly -> BC
    symmetrization.  Affine box lattices generate their element-minor
    coordinates on the device (elements/geometry.py:box_element_coords)."""
    from pfemfort_tpu_torch.assembly.structured import structured_plan

    plan, assemble, _ = structured_plan(mesh, ndof)
    Ke, _ = element_fn(box_element_coords(mesh, affine_box_bounds(mesh),
                                          dtype, device))
    return symmetrize_dirichlet(assemble(Ke, plan), bc_mask)


def _dia_to_dense(A: DIAMatrix) -> np.ndarray:
    n = A.n_rows
    dense = np.zeros((n, n), dtype=np.float64)
    vals = A.vals.detach().cpu().to(torch.float64).numpy()
    for d, o in enumerate(A.offsets):
        rows = np.arange(max(0, -o), min(n, n - o))
        dense[rows, rows + o] = vals[d, rows]
    return dense


def build_gmg(
    mesh: Mesh,
    ndof: int,
    bc_mask_full: np.ndarray,
    element_fn: Callable,
    dtype=torch.float32,
    *,
    device,
    nu: Optional[int] = None,
    omega: Optional[float] = None,
    coarsest_max_dof: int = 4096,
    min_cells: int = 2,
    fine_matrix: Optional[DIAMatrix] = None,
    timings: Optional[dict] = None,
) -> Optional[Tuple[GMGArrays, GMGMeta]]:
    """Build the multigrid hierarchy for a structured mesh.

    Returns None when the mesh has no recognized lattice structure or the
    coarsening chain cannot reach a dense-invertible coarsest level (the
    caller then falls back to Jacobi).  `bc_mask_full` is the (n_node*ndof,)
    Dirichlet mask of the FINE full system.

    Smoothing (nu sweeps of damped Jacobi, weight omega): for ndof = 1 the
    JAX package's (1, 0.8).  For vector problems the JAX package's
    single-device default is the same, but damped Jacobi converges only
    for omega * lambda_max(D^-1 A) < 2, and 3D elasticity has lambda_max
    ~3.4: the cycle turns indefinite from two levels on (ROADMAP C).  So
    for ndof > 1 the defaults are nu = 2 (as the JAX package's distributed
    multigrid, parallel/dist_mg.py) and omega = (4/3) / lambda_max of the
    fine level (power iteration, solve/precond.py; 0.8 is the same rule's
    value for the Poisson lattice).  Pass nu and omega to choose.

    `fine_matrix`: optional pre-assembled AND pre-symmetrized (identity BC
    rows and columns) full-system fine-level DIA on `device`; skips the
    fine-level element assembly, the only expensive level at 48M elements
    (solve/highprec.py).

    `timings`: where the span mg.coarsen_s (the host coarsening chain:
    each coarse mesh and its Dirichlet mask) goes.
    """
    st = mesh.structure or {}
    if st.get("kind") not in ("box_tet", "rect_tria"):
        return None
    device = torch.device(device)

    # --- coarsening chain (host side) ---
    meshes = [mesh]
    masks_np = [np.asarray(bc_mask_full, dtype=bool)]
    with span("mg.coarsen_s", timings):
        while True:
            s = meshes[-1].structure
            dims = ([s["nex"], s["ney"], s["nez"]] if s["kind"] == "box_tet"
                    else [s["nex"], s["ney"]])
            n_dof_here = int(np.prod([d + 1 for d in dims])) * ndof
            if n_dof_here <= coarsest_max_dof:
                break
            if any(d % 2 or d // 2 < min_cells for d in dims):
                break
            coarse, _ = _coarse_box_mesh(meshes[-1])
            shape = full_lattice(meshes[-1])
            sub = masks_np[-1].reshape(*shape, ndof)
            sub = sub[(slice(None, None, 2),) * len(shape)]
            meshes.append(coarse)
            masks_np.append(sub.reshape(-1))

    n_coarsest = meshes[-1].n_node * ndof
    use_cheby = n_coarsest > coarsest_max_dof
    if use_cheby and n_coarsest > (1 << 18):
        return None  # stuck on an odd dimension while genuinely too big

    # --- per-level operators ---
    mats, inv_diags, masks = [], [], []
    for li, (m, bm) in enumerate(zip(meshes, masks_np)):
        bc = torch.as_tensor(bm, device=device)
        if li == 0 and fine_matrix is not None:
            A = fine_matrix
        else:
            A = _assemble_level(m, ndof, element_fn, dtype, device, bc)
        d = dia_diagonal(A)
        mats.append(A)
        inv_diags.append(torch.where(d != 0, 1.0 / d, 0.0))
        masks.append((~bc).to(dtype))

    if nu is None:
        nu = 1 if ndof == 1 else 2
    if omega is None:
        omega = 0.8 if ndof == 1 else _jacobi_weight(mats[0])

    coarse_cheby = None
    if use_cheby:
        Ac = mats[-1]
        # Gershgorin upper bound on the Jacobi-scaled spectrum: a SAFE lmax
        # (power iteration underestimates on clustered spectra, and
        # Chebyshev diverges for eigenvalues above its interval)
        d = dia_diagonal(Ac)
        absrow = Ac.vals.abs().sum(dim=0)
        lmax = float(torch.where(d > 0, absrow / d, 1.0).max())
        # lmin well under the coarse lattice's smallest eigenvalue; degree
        # ~48 reaches ~1e-3 coarse accuracy, plenty for the V-cycle
        coarse_cheby = (lmax, lmax / 200.0, 48)
        coarse_inv = torch.zeros((1, 1), dtype=dtype, device=device)
    else:
        coarse_inv = torch.as_tensor(np.linalg.inv(_dia_to_dense(mats[-1])),
                                     dtype=dtype, device=device)

    arrays = GMGArrays(mats=tuple(mats), inv_diags=tuple(inv_diags),
                       masks=tuple(masks), coarse_inv=coarse_inv)
    meta = GMGMeta(
        shapes=tuple(full_lattice(m) for m in meshes),
        ndof=ndof, nu=nu, omega=omega, coarse_cheby=coarse_cheby)
    return arrays, meta


def _jacobi_weight(A: DIAMatrix) -> float:
    """(4/3) / lambda_max(D^-1 A), lambda_max from power iteration with the
    Chebyshev preconditioner's 5% margin: the damped-Jacobi weight that
    keeps the smoother convergent on the whole spectrum."""
    from pfemfort_tpu_torch.solve.precond import estimate_lmax_jacobi
    from pfemfort_tpu_torch.sparse.ops import operator_and_diag

    op, diag = operator_and_diag(A)
    return (4.0 / 3.0) / (1.05 * float(estimate_lmax_jacobi(op, diag)))


# ---------------------------------------------------------------------------
# the V-cycle
# ---------------------------------------------------------------------------

def _vcycle(arrays: GMGArrays, meta: GMGMeta, level: int,
            r: torch.Tensor, ops, coarse_apply=None) -> torch.Tensor:
    """One V(nu, nu) cycle on level `level`; assumes r == 0 on BC entries."""
    last = len(arrays.mats) - 1
    if level == last:
        if coarse_apply is not None:
            return coarse_apply(r)
        return arrays.coarse_inv @ r

    spmv = ops[level]
    Dinv = arrays.inv_diags[level]
    m = arrays.masks[level]
    om = meta.omega

    e = om * Dinv * r
    for _ in range(meta.nu - 1):
        e = e + om * Dinv * (r - spmv(e))

    rc = arrays.masks[level + 1] * restrict(
        m * (r - spmv(e)), meta.shapes[level], meta.ndof)
    ec = _vcycle(arrays, meta, level + 1, rc, ops, coarse_apply)
    e = e + m * prolong(ec, meta.shapes[level + 1], meta.ndof)

    for _ in range(meta.nu):
        e = e + om * Dinv * (r - spmv(e))
    return e


def cycle_operators(arrays: GMGArrays, meta: GMGMeta):
    """(ops, coarse_apply) for `_vcycle`: each level's product (kernel B1
    on the card) and, when the coarsening chain stuck above the
    dense-inverse cap, the Chebyshev coarsest solve (else None).  Build
    them once, outside the Krylov loop."""
    from pfemfort_tpu_torch.sparse.ops import dia_operator

    ops = tuple(dia_operator(A) for A in arrays.mats)
    coarse_apply = None
    if meta.coarse_cheby is not None:
        from pfemfort_tpu_torch.solve.precond import chebyshev_preconditioner

        lmax, lmin, deg = meta.coarse_cheby
        inv_d = arrays.inv_diags[-1]
        diag_c = torch.where(inv_d != 0, 1.0 / inv_d, 1.0)
        coarse_apply = chebyshev_preconditioner(
            ops[-1], diag_c, lmax=lmax, lmin=lmin, degree=deg)
    return ops, coarse_apply


def gmg_preconditioner(arrays: GMGArrays, meta: GMGMeta) -> Callable:
    """r -> M^{-1} r: one symmetric V-cycle on the free subspace, identity
    on Dirichlet entries (matching the full-system identity BC rows).

    The level operators (kernel B1 on the card) are built here, once,
    outside the Krylov loop."""
    fine_mask = arrays.masks[0]
    ops, coarse_apply = cycle_operators(arrays, meta)

    def precond(r):
        z = _vcycle(arrays, meta, 0, fine_mask * r, ops, coarse_apply)
        # identity on BC components (zero throughout full-system CG started
        # from x0 = bc values, but kept exact anyway)
        return torch.where(fine_mask > 0, z, r)

    return precond
