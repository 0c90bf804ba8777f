# Ported from pfemfort_tpu/drivers/sharded.py (the per-rank DIA and ELL routes).
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
    with the point-to-point stash exchange; the in-shard product is kernel
    B2 on the rank's ghost-extended block).  The ELL route partitions with
    'rcb' when asked for 'slab', as the JAX package does.
Unlike the JAX package, no mesh falls back to replicated assembly.
precond='mg' (the distributed multigrid) and, on the ELL route, 'amg' (the
distributed SA-AMG) are ROADMAP A.9c and raise.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from pfemfort_tpu_torch.assembly.assemble import dirichlet_rhs_correction
from pfemfort_tpu_torch.drivers.common import ImplicitResult
from pfemfort_tpu_torch.mesh.core import Mesh
from pfemfort_tpu_torch.mesh.reorder import recover_structure
from pfemfort_tpu_torch.parallel.dist_assembly import DistSetup, \
    assemble_dia_local, build_dist_setup, local_plan
from pfemfort_tpu_torch.parallel.dist_ell import DistELLSetup, \
    assemble_ell_local, build_dist_ell_setup, build_ell_halo, ell_local_plan
from pfemfort_tpu_torch.parallel.multihost import world
from pfemfort_tpu_torch.parallel.shard_cg import distributed_cg_solve_dia, \
    distributed_cg_solve_ell
from pfemfort_tpu_torch.solve.cg import SolveStats
from pfemfort_tpu_torch.solve.ic0 import build_ic0_shard_block
from pfemfort_tpu_torch.utils.device import resolve_device, \
    synchronize as _sync


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
    block per rank, ELL route only); 'mg' raises, and so does 'amg' on
    the ELL route (ROADMAP A.9c); any other name runs Jacobi, and
    timings["precond_used"] says which ran.  With `recover`, a
    structure-less mesh is first renumbered geometrically
    (mesh/reorder.py) so that its pattern can be a DIA census; the
    solution comes back in the caller's numbering.

    Returns an ImplicitResult on every rank: the whole solution, and
    elem_part, the rank that assembled each element.  Timings: pattern_s
    (the host and device set-up), assemble_s, solve_s (each ends in a
    device synchronise), assembly_layout 'dia' or 'ell',
    distributed_assembly True, precond_requested, precond_used; on the
    ELL route also inshard_kernel ('ell_spmv' on the card, 'spmv_sliced'
    on the CPU) and, with IC(0), ic0_setup_s."""
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
    if precond == "mg":
        raise NotImplementedError(
            "precond='mg' on a sharded solve is the distributed multigrid "
            "of ROADMAP A.9c")

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

    t0 = time.perf_counter()
    try:
        setup = build_dist_setup(mesh, ndof, dirichlet, n_shards, wd.rank,
                                 method=partition_method)
    except ValueError:
        setup = None          # no per-rank DIA layout: the ELL route
    if setup is not None:
        t_pattern = time.perf_counter() - t0
        t0 = time.perf_counter()
        vals, b = assemble_implicit_sharded(setup, element_fn, dtype, device,
                                            force_bc)
        _sync(device)
        timings = dict(pattern_s=t_pattern,
                       assemble_s=time.perf_counter() - t0)
        bjacobi = precond == "bjacobi" and ndof > 1 \
            and setup.rows_per_shard % ndof == 0
        t0 = time.perf_counter()
        x, stats = distributed_cg_solve_dia(
            setup.offsets, vals, b, rtol=rtol, maxiter=maxiter,
            ndof_block=ndof if bjacobi else 1, method=method)
        _sync(device)
        timings.update(solve_s=time.perf_counter() - t0,
                       assembly_layout="dia")
        precond_used = "bjacobi" if bjacobi else "jacobi"
    else:
        if precond == "amg":
            raise NotImplementedError(
                "precond='amg' on the sharded ELL route is the distributed "
                "smoothed-aggregation AMG of ROADMAP A.9c")
        setup = build_dist_ell_setup(
            mesh, ndof, dirichlet, n_shards, wd.rank,
            method="rcb" if partition_method == "slab" else partition_method,
            device=device)
        halo = build_ell_halo(setup.sys, wd.rank, device=device)
        _sync(device)
        t_pattern = time.perf_counter() - t0
        t0 = time.perf_counter()
        vals, b = assemble_implicit_sharded_ell(setup, element_fn, dtype,
                                                device, force_bc)
        _sync(device)
        timings = dict(pattern_s=t_pattern,
                       assemble_s=time.perf_counter() - t0)
        ic0 = None
        if precond == "ic0":
            t0 = time.perf_counter()
            ic0 = build_ic0_shard_block(
                halo.cols_local.cpu().numpy(),
                vals.cpu().to(torch.float64).numpy(), dtype=dtype,
                device=device)
            _sync(device)
            timings["ic0_setup_s"] = time.perf_counter() - t0
        bjacobi = ic0 is None and precond == "bjacobi" and ndof > 1 \
            and setup.rows_per_shard % ndof == 0
        t0 = time.perf_counter()
        x, stats = distributed_cg_solve_ell(
            halo.cols_local, vals, b, halo, rtol=rtol, maxiter=maxiter,
            ndof_block=ndof if bjacobi else 1, ic0=ic0, method=method)
        _sync(device)
        timings.update(solve_s=time.perf_counter() - t0,
                       assembly_layout="ell",
                       inshard_kernel="ell_spmv" if device.type == "cuda"
                       else "spmv_sliced")
        precond_used = "ic0" if ic0 is not None \
            else "bjacobi" if bjacobi else "jacobi"

    sys_ = setup.sys
    x_orig = sys_.reduce_solution(x.cpu().to(torch.float64).numpy())
    timings.update(distributed_assembly=True, precond_requested=precond,
                   precond_used=precond_used)
    return ImplicitResult(
        u_full=sys_.dofmap.expand_solution(x_orig),
        u_reduced=torch.as_tensor(x_orig, dtype=dtype, device=device),
        stats=SolveStats(iters=int(stats.iters), relres=float(stats.relres),
                         converged=bool(stats.converged)),
        timings=timings,
        elem_part=setup.elem_owner)
