# Ported from pfemfort_tpu/parallel/dist_mg.py (per rank: shard_map bodies become each rank's code).
"""Distributed geometric multigrid: per-rank fine level + replicated coarse tail.

The reference's scalable-preconditioner story is PETSc's options-file escape
hatch to hypre/AMG (PFEMFort src/solverpetsc.F:1-8, 198-209) on top of the
MPI row-partitioned KSP CG (SURVEY §2.5).  This module is the multi-rank
MG-preconditioned CG on the generator lattice meshes:

  * the FULL node-dof system is slab-sharded over z-planes of the node
    lattice (rows stay lattice-ordered, so a rank's rows are a z-slab: the
    reference's contiguous row blocks, triapoissonparallelimpl1.F:536-667);
  * each rank assembles ONLY its own z-slab of elements with the structured
    slice-add plan (assembly/structured.py) and sends its one spill plane
    to its right neighbour as one point-to-point pair (the
    MatAssemblyBegin/End stash exchange, solverpetsc.F:447-468);
  * Dirichlet BCs are eliminated SYMMETRICALLY (rows and columns to
    identity, u_bc moved to the rhs), so the operator is SPD and one matrix
    serves both CG and the smoother;
  * the V-cycle's fine level runs per rank: Jacobi smoothing is
    elementwise, the residual product is kernel B1's halo entry
    (parallel/halo.py:spmv_dia_halo_b1; its plain form on the CPU), and the
    z-restriction takes ONE plane from the left neighbour (y/x transfers
    are rank-local);
  * below the fine level the hierarchy is 8x smaller per level, so the
    restricted residual is all_gathered once per cycle and the replicated
    V-cycle (solve/multigrid.py:_vcycle, its levels on B1) runs on every
    rank.  Its input comes from one all_gather and nothing in it uses
    atomics, so every rank computes the same bits.

Every rank calls these functions together, in the default process group
(parallel/multihost.py).  Per preconditioner application: 2 halo
exchanges of the fine products, 1 plane exchange and 1 all_gather of
N/2^ndim values.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pfemfort_tpu_torch.assembly.structured import StructuredPlan, \
    _add_matrix_blocks, _add_rhs_blocks, build_structured_plan
from pfemfort_tpu_torch.dofs.dofmap import build_dofmap
from pfemfort_tpu_torch.elements.geometry import rank_element_coords
from pfemfort_tpu_torch.mesh.core import Mesh
from pfemfort_tpu_torch.parallel.dist_assembly import _send_spill
from pfemfort_tpu_torch.parallel.dist_ell import _exchange
from pfemfort_tpu_torch.parallel.halo import exchange_halos, halo_width, \
    spmv_dia_halo_b1
from pfemfort_tpu_torch.parallel.shard_cg import _gathered, _reduced_dots
from pfemfort_tpu_torch.solve.cg import SolveStats, cg_solve
from pfemfort_tpu_torch.solve.multigrid import GMGArrays, GMGMeta, \
    _coarse_box_mesh, _vcycle, build_gmg, cycle_operators, interp_axis, \
    restrict_axis
from pfemfort_tpu_torch.sparse.dia import DIAMatrix
from pfemfort_tpu_torch.utils.device import resolve_device, \
    synchronize as _sync
from pfemfort_tpu_torch.utils.timing import span


@dataclasses.dataclass
class DistMGSetup:
    """One rank's geometry for the per-rank fine level, and the replicated
    coarse tail (on the rank's device)."""
    n_shards: int
    rank: int
    ndof: int
    nnx: int
    nny: int
    nnz_true: int            # true node planes (nez + 1)
    planes_per_shard: int    # even; Ztot = S * planes_per_shard >= nnz_true
    offsets: Tuple[int, ...]
    w: int                   # flat halo width of the fine product
    plan: StructuredPlan     # entries reused with local z-extents
    coords: np.ndarray       # (npe, ndim, Ecap) float64, this rank's cells
    validz: np.ndarray       # (planes_per_shard,) 1.0 where the z-cell is real
    bc_mask: np.ndarray      # (P,) bool, this rank's rows (True on BC/padding)
    bc_vals: np.ndarray      # (P,) float64
    coarse: Tuple[GMGArrays, GMGMeta]
    nu: int
    omega: Optional[float]   # None: set from the fine level (`with_omega`)

    @property
    def plane_dofs(self) -> int:
        return self.nny * self.nnx * self.ndof

    @property
    def rows_per_shard(self) -> int:
        return self.planes_per_shard * self.plane_dofs

    @property
    def n_rows_padded(self) -> int:
        return self.n_shards * self.rows_per_shard

    @property
    def n_true(self) -> int:
        """Rows of the true (unpadded) full system."""
        return self.nnz_true * self.plane_dofs


def build_dist_mg_setup(
    mesh: Mesh,
    ndof: int,
    dirichlet: np.ndarray,
    element_fn: Callable,
    n_shards: int,
    rank: int,
    dtype=torch.float32,
    nu: int = 1,
    omega: Optional[float] = 0.8,
    coarsest_max_dof: int = 4096,
    *,
    device,
) -> DistMGSetup:
    """Rank `rank`'s element slab of the generator lattice and the
    replicated coarse hierarchy (built on `device` in `dtype`).  Raises
    ValueError when the mesh is not a coarsenable box_tet lattice
    (drivers/sharded.py then falls back to (block-)Jacobi CG).  omega None builds the
    coarse levels with a placeholder weight; `with_omega` sets the real one
    once the fine level is assembled.  `coarsest_max_dof` caps the rows of
    the coarse hierarchy's dense inverse; a chain that stops above it ends
    in a Chebyshev solve (solve/multigrid.py:build_gmg)."""
    st = mesh.structure or {}
    if st.get("kind") != "box_tet":
        raise ValueError("distributed MG needs a box_tet generator mesh")
    nex, ney, nez = st["nex"], st["ney"], st["nez"]
    nnx, nny, nnz_true = nex + 1, ney + 1, nez + 1
    if any(d % 2 for d in (nex, ney, nez)):
        raise ValueError("odd cell counts cannot coarsen")

    # planes per rank: even (keeps every rank's first plane even, so the
    # z-restriction is aligned the same way on every rank)
    pp = -(-nnz_true // n_shards)
    pp += pp % 2
    plane_dofs = nny * nnx * ndof

    plan = build_structured_plan(nex, ney, nez, ndof=ndof)
    offsets = plan.offsets
    w = halo_width(offsets)
    if w > pp * plane_dofs:
        raise ValueError(f"halo {w} exceeds shard rows {pp * plane_dofs}")

    dofmap = build_dofmap(mesh, ndof, dirichlet)
    bc_mask = ~dofmap.free_mask_full()                  # (n_node*ndof,)
    bc_vals = dofmap.bc_values_full

    # this rank's rows of the padded system: padding rows are BC rows (0)
    P = pp * plane_dofs
    n_true = nnz_true * plane_dofs
    r0 = rank * P
    k = max(0, min(n_true - r0, P))
    bc_mask_l = np.ones(P, dtype=bool)
    bc_vals_l = np.zeros(P, dtype=np.float64)
    bc_mask_l[:k] = bc_mask[r0:r0 + k]
    bc_vals_l[:k] = bc_vals[r0:r0 + k]

    # this rank's element slab (elements are z-major, 6 per hex, contiguous);
    # padding cells copy element 0's coordinates and are masked by validz
    epp = ney * nex * 6                                 # elements per z-cell
    z0 = rank * pp
    z1 = min(z0 + pp, nez)
    coords = rank_element_coords(mesh, np.arange(z0 * epp, max(z0, z1) * epp),
                                 pp * epp)
    validz = (np.arange(pp) < z1 - z0).astype(np.float64)

    # replicated coarse tail: the GMG hierarchy built from level 1
    coarse_mesh, _ = _coarse_box_mesh(mesh)
    shape_f = (nnz_true, nny, nnx)
    bc_coarse = bc_mask.reshape(*shape_f, ndof)[::2, ::2, ::2].reshape(-1)
    coarse = build_gmg(coarse_mesh, ndof, bc_coarse, element_fn,
                       dtype=dtype, device=device, nu=nu,
                       omega=1.0 if omega is None else omega,
                       coarsest_max_dof=coarsest_max_dof)
    if coarse is None:
        raise ValueError("coarse hierarchy construction failed")

    return DistMGSetup(
        n_shards=n_shards, rank=rank, ndof=ndof, nnx=nnx, nny=nny,
        nnz_true=nnz_true, planes_per_shard=pp, offsets=offsets, w=w,
        plan=plan, coords=coords, validz=validz,
        bc_mask=bc_mask_l, bc_vals=bc_vals_l, coarse=coarse, nu=nu,
        omega=omega)


def with_omega(setup: DistMGSetup, omega: float) -> DistMGSetup:
    """The setup with damping weight `omega` on every level."""
    arrays, meta = setup.coarse
    return dataclasses.replace(
        setup, omega=float(omega),
        coarse=(arrays, dataclasses.replace(meta, omega=float(omega))))


# ---------------------------------------------------------------------------
# per-rank pieces (every rank calls them together)
# ---------------------------------------------------------------------------

def assemble_fine_shard(setup: DistMGSetup, element_fn: Callable,
                        coords_em: torch.Tensor, validz: torch.Tensor,
                        bc_l: torch.Tensor, bcv_l: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's structured assembly, the one-plane spill to the right
    neighbour and the symmetric Dirichlet elimination.  Returns (vals_l
    (D, P), b_l (P,)) on the rank's device."""
    plan = setup.plan
    nex, ney = plan.nex, plan.ney
    nnx, nny, ndof = setup.nnx, setup.nny, setup.ndof
    D = len(setup.offsets)
    pp = setup.planes_per_shard
    P, w = setup.rows_per_shard, setup.w

    Ke, Fe = element_fn(coords_em)                     # (ns, ns, El), (ns, El)
    vmask = validz[:, None, None, None].expand(pp, ney, nex, 6).reshape(-1)
    Ke = Ke * vmask
    Fe = Fe * vmask

    acc = Ke.new_zeros((D, pp + 1, nny, nnx, ndof))
    rhs = Fe.new_zeros((pp + 1, nny, nnx, ndof))
    _add_matrix_blocks(acc, Ke, plan, 0, pp)
    _add_rhs_blocks(rhs, Fe, plan, 0, pp)
    del Ke, Fe

    # spill plane pp -> the right neighbour's plane 0 (the last rank's
    # spill is dropped); one pair each for the matrix and the rhs
    _send_spill(acc[:, pp], acc[:, 0])
    _send_spill(rhs[pp], rhs[0])
    vals_l = acc[:, :pp].reshape(D, P)
    b_l = rhs[:pp].reshape(P)

    # symmetric Dirichlet elimination: halo-shifted column masks/values
    bcf = bc_l.to(vals_l.dtype)
    ubc = torch.where(bc_l, bcv_l, 0.0).to(vals_l.dtype)
    zero = bcf.new_zeros(w)
    lm, rm = exchange_halos(bcf, w)
    lv, rv = exchange_halos(ubc, w)
    bc_ext = torch.cat([zero if lm is None else lm, bcf,
                        zero if rm is None else rm])
    ub_ext = torch.cat([zero if lv is None else lv, ubc,
                        zero if rv is None else rv])
    d0 = setup.offsets.index(0) if 0 in setup.offsets else -1
    new_vals = []
    for d, o in enumerate(setup.offsets):
        col_bc = bc_ext[w + o:w + o + P]
        col_ub = ub_ext[w + o:w + o + P]
        b_l = b_l - vals_l[d] * col_ub                 # move u_bc to the rhs
        v = torch.where(col_bc > 0, 0.0, vals_l[d])    # zero BC columns
        v = torch.where(bc_l, 1.0 if d == d0 else 0.0, v)
        new_vals.append(v)
    vals_l = torch.stack(new_vals)
    b_l = torch.where(bc_l, bcv_l.to(vals_l.dtype), b_l)
    return vals_l, b_l


def restrict_shard(setup: DistMGSetup, r_lat: torch.Tensor) -> torch.Tensor:
    """Rank-local 3-axis restriction; z needs the left neighbour's last odd
    plane (one pair).  r_lat: (pp, nny, nnx, ndof) -> (pp//2, nyc, nxc,
    ndof)."""
    f = restrict_axis(restrict_axis(r_lat, 1), 2)
    ev = f[0::2]
    od = f[1::2]
    rank, size = dist.get_rank(), dist.get_world_size()
    left = torch.zeros_like(od[-1:])
    _exchange([(rank + 1, od[-1:])] if rank < size - 1 else [],
              [(rank - 1, left)] if rank > 0 else [])
    od_prev = torch.cat([left, od[:-1]], dim=0)
    return ev + 0.5 * (od_prev + od)


def prolong_shard(setup: DistMGSetup, ec_full: torch.Tensor,
                  rank: int) -> torch.Tensor:
    """Replicated full coarse correction -> this rank's fine slab.

    ec_full: (Zc_pad, nyc, nxc, ndof) with Zc_pad = Ztot//2 + 1 (zero beyond
    the true coarse planes).  Returns (pp, nny, nnx, ndof)."""
    pp = setup.planes_per_shard
    ppc = pp // 2
    k0 = rank * ppc
    ev = ec_full[k0:k0 + ppc]
    nxt = ec_full[k0 + 1:k0 + 1 + ppc]
    od = 0.5 * (ev + nxt)
    z = torch.stack([ev, od], dim=1).reshape((pp,) + tuple(ev.shape[1:]))
    return interp_axis(interp_axis(z, 1), 2)


def fine_spmv_factory(setup: DistMGSetup, vals_l: torch.Tensor) -> Callable:
    """x_l -> (A x)_l for the per-rank fine level: kernel B1's halo entry on
    a card tensor, its plain form on a CPU tensor (both through
    parallel/halo.py:spmv_dia_halo_b1)."""
    A_l = DIAMatrix(vals=vals_l, offsets=tuple(setup.offsets),
                    n_rows=setup.rows_per_shard)
    return lambda x_l: spmv_dia_halo_b1(A_l, x_l, setup.w)


def coarse_solver(setup: DistMGSetup, coarse_arrays: GMGArrays) -> Callable:
    """rc (the replicated coarse residual, flat) -> ec: one replicated
    V-cycle of the coarse hierarchy, its level products on kernel B1, with
    a Chebyshev coarsest solve when the coarsening chain stuck on an odd
    dimension above the dense-inverse cap (solve/multigrid.py:
    cycle_operators).  Build it outside the Krylov loop."""
    meta_c = setup.coarse[1]
    ops, coarse_apply = cycle_operators(coarse_arrays, meta_c)
    return lambda rc: _vcycle(coarse_arrays, meta_c, 0,
                              coarse_arrays.masks[0] * rc, ops, coarse_apply)


def gathered_coarse_residual(setup: DistMGSetup,
                             rc_l: torch.Tensor) -> torch.Tensor:
    """Every rank's restricted residual, all_gathered once and cut to the
    true coarse planes: the replicated coarse residual (flat)."""
    nnz_c = (setup.nnz_true - 1) // 2 + 1
    rc_all = _gathered(rc_l.reshape(-1)).reshape((-1,) + tuple(rc_l.shape[1:]))
    return rc_all[:nnz_c].reshape(-1)


def dist_gmg_preconditioner(setup: DistMGSetup, inv_diag_l: torch.Tensor,
                            mask_l: torch.Tensor, coarse_arrays: GMGArrays,
                            spmv: Callable) -> Callable:
    """r_l -> M^{-1} r_l: per-rank fine smoothing and transfers and the
    replicated coarse tail.  `spmv`: the fine level's per-rank operator
    (`fine_spmv_factory`).  Build it outside the Krylov loop."""
    pp = setup.planes_per_shard
    nny, nnx, ndof = setup.nny, setup.nnx, setup.ndof
    om = setup.omega
    nnz_c = (setup.nnz_true - 1) // 2 + 1      # true coarse planes
    zc_pad = (setup.n_shards * pp) // 2 + 1
    nyc, nxc = (nny - 1) // 2 + 1, (nnx - 1) // 2 + 1
    coarse = coarse_solver(setup, coarse_arrays)
    rank = dist.get_rank()

    def precond(r_l):
        # the masked copy feeds the cycle (so it stays SPD with nonzero BC
        # residuals); the ORIGINAL r_l comes back on BC rows, as
        # solve/multigrid.py:gmg_preconditioner does
        rm = mask_l * r_l
        e = om * inv_diag_l * rm
        for _ in range(setup.nu - 1):
            e = e + om * inv_diag_l * (rm - spmv(e))

        r1 = (mask_l * (rm - spmv(e))).reshape(pp, nny, nnx, ndof)
        rc = gathered_coarse_residual(setup, restrict_shard(setup, r1))
        ec = coarse(rc)

        ec_pad = ec.new_zeros((zc_pad, nyc, nxc, ndof))
        ec_pad[:nnz_c] = ec.reshape(nnz_c, nyc, nxc, ndof)
        e = e + mask_l * prolong_shard(setup, ec_pad, rank).reshape(-1)

        for _ in range(setup.nu):
            e = e + om * inv_diag_l * (rm - spmv(e))
        return torch.where(mask_l > 0, e, r_l)

    return precond


def fine_jacobi_weight(setup: DistMGSetup, spmv: Callable,
                       diag_l: torch.Tensor, iters: int = 12) -> float:
    """(4/3) / (1.05 lambda_max(D^-1 A)) of the fine level over every rank:
    solve/precond.py:estimate_lmax_jacobi's power iteration (12 steps from
    sin(global row + 1)) with its norms reduced across ranks and the padding
    rows held at zero.  At world size 1 this is
    solve/multigrid.py:_jacobi_weight of the single-device fine level."""
    P = setup.rows_per_shard
    r0 = setup.rank * P
    k = max(0, min(setup.n_true - r0, P))
    dinv = torch.where(diag_l != 0, 1.0 / diag_l, 1.0)

    def norm(v):
        # the true rows alone, so that at world size 1 the norm is the
        # single-device one, bit for bit (sqrt(x^2) == x)
        s = torch.linalg.vector_norm(v[:k]).square().reshape(1)
        if dist.get_world_size() > 1:
            dist.all_reduce(s)
        return s[0].sqrt()

    v = torch.sin(torch.arange(r0, r0 + P, dtype=diag_l.dtype,
                               device=diag_l.device) + 1.0)
    v[k:] = 0.0     # padding rows: decoupled identity rows, held at zero
    v = v / norm(v)
    lam = torch.ones((), dtype=diag_l.dtype, device=diag_l.device)
    for _ in range(iters):
        w = dinv * spmv(v)
        lam = norm(w)
        v = w / torch.where(lam > 0, lam, 1.0)
    return (4.0 / 3.0) / (1.05 * float(lam))


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------

def solve_sharded_mg(
    mesh: Mesh,
    ndof: int,
    dirichlet: np.ndarray,
    element_fn: Callable,
    dtype=torch.float32,
    rtol: float = 1e-6,
    maxiter: int = 200,
    device="cuda",
    nu: Optional[int] = None,
    omega: Optional[float] = None,
    coarsest_max_dof: int = 4096,
) -> Tuple[np.ndarray, SolveStats, Dict]:
    """Multi-rank MG-preconditioned CG on the full node-dof system; every
    rank of the default process group calls it together, on `device` (its
    card under NCCL, the CPU under gloo).

    Returns (u_full (n_node*ndof,) float64 on every rank, SolveStats,
    timings).  A rank's fine-level memory is O(N/S); the replicated coarse
    tail is O(N/8).  Dirichlet BCs only (drivers/sharded.py refuses
    ForceBCs).

    Smoothing, with nu and omega left at None: Poisson (ndof = 1) keeps the
    JAX package's nu = 1, omega = 0.8.  Vector problems do not take the JAX
    package's (2, 0.6), under which the cycle is indefinite on 3D
    elasticity (ROADMAP C.9): nu = 2 and omega = (4/3) / (1.05
    lambda_max(D^-1 A)) of the fine level (`fine_jacobi_weight`), the
    single-device port's rule, on every level.  A value passed is used as
    given, as in the JAX package.  `coarsest_max_dof`: the JAX package's
    cap on the coarse hierarchy's dense inverse (`build_dist_mg_setup`).
    Timings: pattern_s (the rank's host set-up and the coarse hierarchy),
    assemble_s (the fine level and, for ndof > 1, its weight), solve_s,
    planes_per_shard, mg_omega, mg_nu, mg_levels, distributed_mg."""
    device = resolve_device(device)
    rank, size = dist.get_rank(), dist.get_world_size()

    timings = {}
    with span("pattern_s", timings):
        if nu is None:
            nu = 1 if ndof == 1 else 2
        if omega is None and ndof == 1:
            omega = 0.8
        setup = build_dist_mg_setup(mesh, ndof, dirichlet, element_fn, size,
                                    rank, dtype=dtype, nu=nu, omega=omega,
                                    coarsest_max_dof=coarsest_max_dof,
                                    device=device)
        _sync(device)

    as_dev = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device=device)
    with span("assemble_s", timings):
        bc_l = torch.as_tensor(setup.bc_mask, device=device)
        bcv_l = as_dev(setup.bc_vals)
        vals_l, b_l = assemble_fine_shard(setup, element_fn,
                                          as_dev(setup.coords),
                                          as_dev(setup.validz), bc_l, bcv_l)
        d0 = setup.offsets.index(0) if 0 in setup.offsets else 0
        diag = vals_l[d0]
        inv_diag = torch.where(diag != 0, 1.0 / diag, 0.0)
        mask_l = torch.where(bc_l, 0.0, 1.0).to(dtype)
        spmv_fine = fine_spmv_factory(setup, vals_l)
        if setup.omega is None:
            setup = with_omega(setup,
                               fine_jacobi_weight(setup, spmv_fine, diag))
        _sync(device)

    coarse_arrays, _ = setup.coarse
    precond = dist_gmg_preconditioner(setup, inv_diag, mask_l,
                                      coarse_arrays, spmv_fine)
    dot, dot2 = _reduced_dots()
    with span("solve_s", timings):
        x_l, stats = cg_solve(spmv_fine, b_l, x0=bcv_l, precond=precond,
                              rtol=rtol, maxiter=maxiter, dot=dot, dot2=dot2)
        x = _gathered(x_l)
        _sync(device)

    u_full = x[:setup.n_true].cpu().to(torch.float64).numpy()
    timings.update(planes_per_shard=setup.planes_per_shard,
                   mg_omega=setup.omega, mg_nu=setup.nu,
                   mg_levels=1 + len(coarse_arrays.mats),
                   distributed_mg=True)
    return u_full, SolveStats(iters=int(stats.iters),
                              relres=float(stats.relres),
                              converged=bool(stats.converged)), timings
