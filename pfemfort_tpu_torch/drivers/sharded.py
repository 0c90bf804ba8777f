# Ported from pfemfort_tpu/drivers/sharded.py (the per-rank DIA, ELL and MG routes).
"""Multi-rank implicit solve: partition -> PER-RANK assembly -> Krylov.

The port's form of the reference's parallel drivers
(tetrapoissonparallelimpl1 et al., SURVEY §3.1): a slab (or RCB, greedy)
partition replaces METIS, shard-contiguous renumbering replaces
node_start/node_end, each rank assembles ONLY its own elements (the
reference's elem_procid ownership loop, triapoissonparallelimpl1.F:849-905)
with a point-to-point ghost reduction in place of PETSc's MatAssembly
stash exchange, and a halo- or ghost-exchange Krylov solve replaces
KSPSolve over MPI.  Full-size coordinates, element matrices and A never
exist on any one device.

Every rank calls `solve_implicit_sharded` together, in a process group set
up by parallel/multihost.py:initialize (NCCL on the card, one card per
rank; gloo on the CPU).  Two routes, recorded in
timings["assembly_layout"]:
  * 'dia': a mesh whose shard-ordered pattern is a DIA census with a halo
    no wider than a rank's rows (parallel/dist_assembly.py; the in-shard
    product is kernel B1's halo entry on the card);
  * 'ell': every other mesh (parallel/dist_ell.py: per-rank ELL assembly
    with the point-to-point stash exchange).  A float32 system's in-shard
    product is the per-rank hybrid (kernel B1 on the rank's dense local
    diagonals and its own x, kernel B2 on the remainder and the ghost
    columns), as in the JAX package; a float64 one, or one with no dense
    diagonal, is kernel B2 on the rank's whole ghost-extended block.  The
    ELL route partitions with 'rcb' when asked for 'slab', as the JAX
    package does.
Unlike the JAX package, no mesh falls back to replicated assembly.
precond='mg' takes a third route on a coarsenable box_tet lattice without
ForceBCs: the distributed geometric multigrid (parallel/dist_mg.py, the
full node-dof system, CG; timings["distributed_mg"]); elsewhere it runs
(block-)Jacobi and says why in timings["mg_refused"].  precond='amg' on the
ELL route is the distributed SA-AMG (solve/amg.py:build_dist_samg).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from pfemfort_tpu_torch.assembly.assemble import dirichlet_rhs_correction
from pfemfort_tpu_torch.dofs.dofmap import build_dofmap
from pfemfort_tpu_torch.drivers.common import ImplicitResult
from pfemfort_tpu_torch.mesh.core import Mesh
from pfemfort_tpu_torch.mesh.reorder import recover_structure
from pfemfort_tpu_torch.parallel.dist_assembly import DistSetup, \
    assemble_dia_local, build_dist_setup, local_plan
from pfemfort_tpu_torch.parallel.dist_ell import DistELLSetup, \
    assemble_ell_local, build_dist_ell_setup, build_ell_halo, \
    build_ell_halo_hybrid, ell_local_plan
from pfemfort_tpu_torch.parallel.multihost import world
from pfemfort_tpu_torch.parallel.dist_mg import solve_sharded_mg
from pfemfort_tpu_torch.parallel.shard_cg import _gathered, \
    distributed_cg_solve_dia, distributed_cg_solve_ell
from pfemfort_tpu_torch.solve.amg import build_dist_samg
from pfemfort_tpu_torch.solve.cg import SolveStats
from pfemfort_tpu_torch.solve.ic0 import build_ic0_shard_block
from pfemfort_tpu_torch.sparse.hybrid import hybrid_layout
from pfemfort_tpu_torch.utils.device import resolve_device, \
    synchronize as _sync
from pfemfort_tpu_torch.utils.timing import span


def _force_vector(dofmap, eq_perm, n_rows_padded, force_bc) -> np.ndarray:
    """Nodal ForceBC rows -> padded shard-ordered external force vector
    (the reference's rhs VecSetValues with row-ownership guard,
    triaelasticityparallelimpl1.F:976-987)."""
    fvec = np.zeros(dofmap.total_dof, dtype=np.float64)
    rows = dofmap.node_dof[force_bc[:, 0].astype(np.int64),
                           force_bc[:, 1].astype(np.int64)]
    keep = rows >= 0
    np.add.at(fvec, rows[keep], force_bc[keep, 2])
    out = np.zeros(n_rows_padded, dtype=np.float64)
    out[eq_perm] = fvec
    return out


def assemble_implicit_sharded(
    setup: DistSetup,
    element_fn: Callable,
    dtype: torch.dtype,
    device,
    force_bc: Optional[np.ndarray] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's element kernels, its local DIA sums and the ghost
    reduction with its neighbours.  Every rank calls it together.

    Returns (vals (D, P), b (P,)): the rank's rows [rank*P, (rank+1)*P)
    of the shard-ordered system, on `device`."""
    s = world().rank
    if setup.rank != s:
        raise ValueError(f"rank {s} was given the block of rank "
                         f"{setup.rank}")
    sys_ = setup.sys
    P, w = sys_.rows_per_shard, setup.w
    as_dev = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device=device)
    edt = as_dev(setup.edt, torch.int32)
    plan = local_plan(edt, setup.offsets, P, w)
    Ke, Fe_src = element_fn(as_dev(setup.coords))
    Fe = Fe_src + dirichlet_rhs_correction(Ke, as_dev(setup.ubc))
    del Fe_src
    vals, b = assemble_dia_local(Ke, Fe, plan)
    fext = _own_force(setup, device, dtype, force_bc)
    return vals, (b if fext is None else b + fext)


def _own_force(setup, device, dtype, force_bc) -> Optional[torch.Tensor]:
    """This rank's rows of the shard-ordered ForceBC vector, or None."""
    if force_bc is None or not len(force_bc):
        return None
    sys_, s = setup.sys, setup.rank
    P = sys_.rows_per_shard
    fext = _force_vector(sys_.dofmap, sys_.eq_perm, sys_.n_rows_padded,
                         force_bc)
    return torch.as_tensor(fext[s * P:(s + 1) * P], dtype=dtype,
                           device=device)


def assemble_implicit_sharded_ell(
    setup: DistELLSetup,
    element_fn: Callable,
    dtype: torch.dtype,
    device,
    force_bc: Optional[np.ndarray] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's element kernels, one sorted local ELL scatter and the
    stash exchange with the ranks it shares rows with (the general-mesh
    MatAssembly, parallel/dist_ell.py).  Every rank calls it together.

    Returns (vals (P, K), b (P,)): the rank's rows [rank*P, (rank+1)*P)
    of the shard-ordered ELL system, on `device`."""
    s = world().rank
    if setup.rank != s:
        raise ValueError(f"rank {s} was given the block of rank "
                         f"{setup.rank}")
    as_dev = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    Ke, Fe_src = element_fn(as_dev(setup.coords))
    Fe = Fe_src + dirichlet_rhs_correction(Ke, as_dev(setup.ubc))
    del Fe_src
    vals, b = assemble_ell_local(Ke, Fe, ell_local_plan(setup))
    fext = _own_force(setup, device, dtype, force_bc)
    return vals, (b if fext is None else b + fext)


def solve_implicit_sharded(
    mesh: Mesh,
    ndof: int,
    dirichlet: np.ndarray,
    element_fn: Callable,
    n_shards: Optional[int] = None,
    force_bc: Optional[np.ndarray] = None,
    dtype: Optional[torch.dtype] = None,
    rtol: float = 1e-8,
    maxiter: int = 10_000,
    partition_method: str = "slab",
    precond: str = "jacobi",
    recover: bool = True,
    method: str = "cg",
    device="cuda",
) -> ImplicitResult:
    """Multi-rank implicit solve (the module docstring has the design).

    Every rank of the default process group calls it with the same
    arguments; `n_shards` (default: the world size) must equal the world
    size.  `device` is 'cuda' (each rank on the card of its local rank,
    NCCL) or 'cpu' (gloo), and must match the group's backend.
    `method`: 'cg' | 'bicgstab' | 'gmres', the distributed Krylov menu
    (the reference's -ksp_type switch, PFEMFort src/solverpetsc.F:198).
    `precond`, under every method: 'jacobi'; 'bjacobi' (per-node blocks,
    ndof > 1 with rows per rank a multiple of ndof); 'ic0' (one IC(0)
    block per rank, ELL route only); 'amg' (the distributed SA-AMG, ELL
    route only; Jacobi where the system does not coarsen); any other name
    runs Jacobi, and timings["precond_used"] says which ran.  'mg' is the
    distributed geometric multigrid on a coarsenable box_tet lattice
    without ForceBCs, solved with CG whatever `method` says (as in the JAX
    package); elsewhere (block-)Jacobi, with the reason in
    timings["mg_refused"].  With `recover`, a
    structure-less mesh is first renumbered geometrically
    (mesh/reorder.py) so that its pattern can be a DIA census; the
    solution comes back in the caller's numbering.

    Returns an ImplicitResult on every rank: the whole solution, and
    elem_part, the rank that assembled each element.  Timings: pattern_s
    (the host and device set-up), assemble_s, solve_s (each ends in a
    device synchronise), assembly_layout 'dia' or 'ell',
    distributed_assembly True, precond_requested, precond_used; on the
    ELL route also inshard_kernel ('hybrid' for a float32 system with
    dense local diagonals, with hybrid_diagonals, the same on every rank,
    this rank's hybrid_nnz_dia, hybrid_nnz_rem and hybrid_k_rem, and
    hybrid_setup_s, the split's share of pattern_s; else
    'ell_spmv' on the card, 'spmv_sliced' on the CPU) and, with IC(0),
    ic0_setup_s; with SA-AMG amg_setup_s,
    amg_levels and amg_host_bytes (the values all-gathered to each rank's
    host).  The MG route's timings are solve_sharded_mg's."""
    wd = world()
    device = resolve_device(device)
    if device.type != wd.device.type:
        raise ValueError(f"device={str(device)!r}, but the process group's "
                         f"ranks run on {wd.device.type} (NCCL: cuda, gloo: "
                         "cpu)")
    device = wd.device
    if n_shards is None:
        n_shards = wd.size
    if n_shards != wd.size:
        raise ValueError(f"n_shards={n_shards}, but the process group has "
                         f"{wd.size} ranks: one shard per rank")
    if dtype is None:
        dtype = torch.get_default_dtype()

    if recover and mesh.structure is None:
        rec = recover_structure(mesh, ndof, dirichlet, force_bc)
        if rec is not None:
            mesh2, dbc2, fbc2, perm, dofmap0 = rec
            res = solve_implicit_sharded(
                mesh2, ndof, dbc2, element_fn, force_bc=fbc2, dtype=dtype,
                rtol=rtol, maxiter=maxiter,
                partition_method=partition_method, precond=precond,
                recover=False, method=method, device=device)
            u_full = res.u_full.reshape(mesh.n_node, ndof)[perm].reshape(-1)
            return ImplicitResult(
                u_full=u_full,
                u_reduced=torch.as_tensor(u_full[dofmap0.assy_for_soln],
                                          dtype=dtype, device=device),
                stats=res.stats,
                timings=dict(res.timings, structure_recovered=True),
                elem_part=res.elem_part)

    precond_requested = precond
    mg_refused = None
    if precond == "mg":
        if force_bc is None or not len(force_bc):
            try:
                res = _solve_mg_sharded(mesh, ndof, dirichlet, element_fn,
                                        dtype, rtol, maxiter, device)
                res.timings.update(precond_requested="mg",
                                   precond_used="mg")
                return res
            except ValueError as ex:
                mg_refused = str(ex)
        else:
            mg_refused = "distributed MG does not support ForceBCs"
        precond = "bjacobi" if ndof > 1 else "jacobi"

    timings = {}
    with span("pattern_s", timings):
        try:
            setup = build_dist_setup(mesh, ndof, dirichlet, n_shards,
                                     wd.rank, method=partition_method)
        except ValueError:
            setup = None          # no per-rank DIA layout: the ELL route
    if setup is not None:
        with span("assemble_s", timings):
            vals, b = assemble_implicit_sharded(setup, element_fn, dtype,
                                                device, force_bc)
            _sync(device)
        bjacobi = precond == "bjacobi" and ndof > 1 \
            and setup.rows_per_shard % ndof == 0
        with span("solve_s", timings):
            x, stats = distributed_cg_solve_dia(
                setup.offsets, vals, b, rtol=rtol, maxiter=maxiter,
                ndof_block=ndof if bjacobi else 1, method=method)
            _sync(device)
        timings["assembly_layout"] = "dia"
        precond_used = "bjacobi" if bjacobi else "jacobi"
    else:
        with span("pattern_s", timings):
            setup = build_dist_ell_setup(
                mesh, ndof, dirichlet, n_shards, wd.rank,
                method="rcb" if partition_method == "slab"
                else partition_method,
                device=device)
            halo = build_ell_halo(setup.sys, wd.rank, device=device)
            # float32 systems go through the per-rank hybrid, as in the JAX
            # package (drivers/sharded.py there) and on one device
            # (drivers/common.py); float64 ones stay on B2
            with span("hybrid_setup_s", timings):
                plan = build_ell_halo_hybrid(halo) \
                    if dtype == torch.float32 else None
                split = None if plan is None else hybrid_layout(plan, device)
                _sync(device)
        with span("assemble_s", timings):
            vals, b = assemble_implicit_sharded_ell(setup, element_fn, dtype,
                                                    device, force_bc)
            hybrid = None if split is None else split.pack(vals)
            _sync(device)
        if plan is None:
            del timings["hybrid_setup_s"]
        else:
            timings.update(hybrid_diagonals=plan.D,
                           hybrid_nnz_dia=plan.nnz_dia,
                           hybrid_nnz_rem=plan.nnz_rem,
                           hybrid_k_rem=plan.k_rem)
        amg = ic0 = None
        if precond == "amg":
            with span("amg_setup_s", timings):
                amg, host_bytes = _dist_samg(setup.sys, mesh, ndof, vals,
                                             dtype, device)
                _sync(device)
            timings["amg_host_bytes"] = host_bytes
            if amg is not None:
                timings["amg_levels"] = list(amg.metas[0].sizes)
        if precond == "ic0":
            with span("ic0_setup_s", timings):
                ic0 = build_ic0_shard_block(
                    halo.cols_local.cpu().numpy(),
                    vals.cpu().to(torch.float64).numpy(), dtype=dtype,
                    device=device)
                _sync(device)
        bjacobi = ic0 is None and amg is None and precond == "bjacobi" \
            and ndof > 1 and setup.rows_per_shard % ndof == 0
        with span("solve_s", timings):
            x, stats = distributed_cg_solve_ell(
                halo.cols_local, vals, b, halo, rtol=rtol, maxiter=maxiter,
                ndof_block=ndof if bjacobi else 1, ic0=ic0, method=method,
                amg=amg, hybrid=hybrid)
            _sync(device)
        timings.update(assembly_layout="ell",
                       inshard_kernel="hybrid" if hybrid is not None
                       else "ell_spmv" if device.type == "cuda"
                       else "spmv_sliced")
        precond_used = "amg" if amg is not None else "ic0" \
            if ic0 is not None else "bjacobi" if bjacobi else "jacobi"

    sys_ = setup.sys
    x_orig = sys_.reduce_solution(x.cpu().to(torch.float64).numpy())
    timings.update(distributed_assembly=True,
                   precond_requested=precond_requested,
                   precond_used=precond_used)
    if mg_refused is not None:
        timings["mg_refused"] = mg_refused
    return ImplicitResult(
        u_full=sys_.dofmap.expand_solution(x_orig),
        u_reduced=torch.as_tensor(x_orig, dtype=dtype, device=device),
        stats=SolveStats(iters=int(stats.iters), relres=float(stats.relres),
                         converged=bool(stats.converged)),
        timings=timings,
        elem_part=setup.elem_owner)


def _dist_samg(sys_, mesh: Mesh, ndof: int, vals: torch.Tensor,
               dtype: torch.dtype, device):
    """This rank's share of the distributed SA-AMG hierarchy of the ELL
    route's system, and the bytes of values gathered to its host.  Every
    rank's (P, K) values are all-gathered in the solve's dtype and cast to
    float64 on the host (the JAX package's `_host_values(...)
    .astype(np.float64)`), with the rigid-body near-nullspace rows for
    ndof > 1; every rank then builds the same hierarchy."""
    pat = sys_.pattern
    vals_h = _gathered(vals.reshape(-1)).cpu()
    host_bytes = vals_h.numel() * vals_h.element_size()
    vals_h = vals_h.to(torch.float64).numpy().reshape(pat.n_rows, -1)
    row_deg = np.diff(pat.indptr)
    within = (np.arange(pat.nnz, dtype=np.int64)
              - np.repeat(pat.indptr[:-1], row_deg))
    csr_row = np.repeat(np.arange(pat.n_rows, dtype=np.int64), row_deg)
    rows_xyz = np.zeros((sys_.n_rows_padded, mesh.ndim))
    rows_comp = np.zeros(sys_.n_rows_padded, dtype=np.int64)
    nodedof = sys_.dofmap.assy_for_soln
    rows_xyz[sys_.eq_perm] = mesh.coords[nodedof // ndof]
    rows_comp[sys_.eq_perm] = nodedof % ndof
    amg = build_dist_samg(
        pat.indptr, pat.indices, vals_h[csr_row, within],
        sys_.n_rows_padded, sys_.n_shards, world().rank, ndof=ndof,
        coords_rows=rows_xyz, comp_rows=rows_comp, dtype=dtype,
        device=device)
    return amg, host_bytes


def _solve_mg_sharded(mesh: Mesh, ndof: int, dirichlet: np.ndarray,
                      element_fn: Callable, dtype: torch.dtype, rtol: float,
                      maxiter: int, device) -> ImplicitResult:
    """precond='mg': the distributed V-cycle CG
    (parallel/dist_mg.py:solve_sharded_mg), its full-system solution mapped
    back to the ImplicitResult contract (no elem_part, as in the JAX
    package)."""
    u_full, stats, timings = solve_sharded_mg(
        mesh, ndof, dirichlet, element_fn, dtype=dtype, rtol=rtol,
        maxiter=maxiter, device=device)
    dofmap = build_dofmap(mesh, ndof, dirichlet)
    # exact BC values on Dirichlet rows (the identity rows carry them
    # already; merged from the dofmap for float64 exactness)
    u_full = np.where(dofmap.free_mask_full(), u_full, dofmap.bc_values_full)
    timings["distributed_assembly"] = True
    return ImplicitResult(
        u_full=u_full,
        u_reduced=torch.as_tensor(u_full[dofmap.assy_for_soln], dtype=dtype,
                                  device=device),
        stats=stats, timings=timings)
