# Ported from pfemfort_tpu/drivers/cli.py (single device).
"""Command-line drivers mirroring the reference executable matrix.

Every reference solver is a standalone PROGRAM run as
  mpirun -np N <exe> <nodefile> <elemfile> <DirichletBCfile> [<ForceBCfile>]
(PFEMFort bin/makefile:3-11).  One CLI exposes the same problem
matrix as subcommands with the same positional-file convention, the same
options and the same printed milestones as the JAX package's CLI:

  python -m pfemfort_tpu_torch poisson     <nodes> <elems> <dbc> [-o out.vtk]
  python -m pfemfort_tpu_torch elasticity  <nodes> <elems> <dbc> [fbc] ...
  python -m pfemfort_tpu_torch explicit    <nodes> <elems> <dbc> [fbc] --preset tria
  python -m pfemfort_tpu_torch cfd         <nodes> <elems> <velocityBC> [-o out.vtk]
  python -m pfemfort_tpu_torch genmesh     tet x0 x1 nex y0 y1 ney z0 z1 nez -o prefix
  python -m pfemfort_tpu_torch partition   <nodes> <elems> --nparts 4 [-o part.vtk]
  python -m pfemfort_tpu_torch vtktovtu    in.vtk out.vtu
  python -m pfemfort_tpu_torch bench       [n] [n_large] [n_large_unstr]

The solving subcommands add two options of their own: `--device` (default
cuda; without a card the run fails, pass `--device cpu` to run on the
CPU) and `--dtype` (float32 by default, as the JAX CLI without x64; the
port's counterpart of `jax_enable_x64` is `--dtype float64`).

`poisson` and `elasticity` take `--shards N`: the per-rank solve of
drivers/sharded.py on N ranks (the DIA route, or the ELL route for a mesh
without a per-rank DIA layout; `--precond ic0|bjacobi|amg` applies there,
and `--precond mg` takes the distributed multigrid's Jacobi fall-back: a
mesh read from files has no generator structure, as in the JAX CLI).
Without `--shards`, `elasticity --precond jacobi|ic0|amg` preconditions
the reduced system (the JAX CLI ignores it there and runs Jacobi); its
other choices are refused.
Under torchrun (RANK in the environment)
each process is one rank of the group torchrun set up; launched by hand,
the command re-runs itself under torchrun with N rank processes
(parallel/multihost.py:torchrun_ranks).  `--device cuda` needs N cards (one per rank,
NCCL), `--device cpu` runs the ranks on gloo.  Rank 0 alone prints the
report and writes the output, with each element's rank as the VTK file's
procid.  `bench` runs the port's bench harness (pfemfort_tpu_torch/bench.py)
with n (default 72, as the JAX CLI's) and the rest of its arguments.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
# what `elasticity --precond` takes without --shards: the reduced solve's
_SINGLE_ELASTICITY_PRECONDS = ("jacobi", "ic0", "amg")


def _read(args):
    from pfemfort_tpu_torch.mesh import io as mesh_io

    mesh = mesh_io.read_mesh(args.nodes, args.elems)
    dbc = mesh_io.read_bcs(args.dbc)
    fbc = mesh_io.read_bcs(args.fbc) if getattr(args, "fbc", None) else None
    return mesh, dbc, fbc


def _device(args):
    """The --device/--dtype pair; a CUDA device without a card fails."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: torch.cuda.is_available() "
                         "is false (pass --device cpu to run on the CPU)")
    return device, _DTYPES[args.dtype]


def _launch_ranks(args, argv):
    """A `--shards N` command: as one rank under torchrun, join the process
    group and return None; launched by hand, run the same command as N
    torchrun ranks and return torchrun's exit code."""
    from pfemfort_tpu_torch.parallel import multihost

    n, device = args.shards, torch.device(args.device)
    if "RANK" not in os.environ:
        if device.type == "cuda" and torch.cuda.device_count() < n:
            raise SystemExit(
                f"--shards {n} --device {args.device} needs {n} CUDA cards "
                f"(one per rank), found {torch.cuda.device_count()} (pass "
                "--device cpu to run the ranks on the CPU)")
        return multihost.torchrun_ranks(["-m", "pfemfort_tpu_torch", *argv],
                                        n)
    multihost.initialize(device=device.type)
    return None


def _solve_sharded(args, mesh, ndof, dbc, element_fn, fbc=None):
    from pfemfort_tpu_torch.drivers.sharded import solve_implicit_sharded

    return solve_implicit_sharded(
        mesh, ndof, dbc, element_fn, n_shards=args.shards, force_bc=fbc,
        dtype=_DTYPES[args.dtype], rtol=args.rtol, precond=args.precond,
        method=args.ksp, device=args.device)


def _report(mesh, ndof, res, t0):
    # Same user-visible milestones as the reference drivers: mesh stats,
    # iteration count, wall-clock (triapoissonparallelimpl1.F:373-384,914-921).
    print(f" Mesh statistics: nElem {mesh.n_elem}  nNode {mesh.n_node}  "
          f"npElem {mesh.npe}  ndof {ndof}")
    iters = int(res.stats.iters)
    if res.stats.converged:
        print(f" Convergence in {iters} iterations, "
              f"relres {float(res.stats.relres):.3e}")
    else:
        print(f" Fails to converge within {iters} iterations "
              f"(relres {float(res.stats.relres):.3e})")
    print(f" That took {time.perf_counter() - t0:.3f} seconds")


def _write_output(args, mesh, ndof, res):
    if args.output:
        from pfemfort_tpu_torch.io.vtk import write_vtk

        write_vtk(args.output, mesh, res.u_full, ndof,
                  elem_procid=res.elem_part)
        print(f" Wrote {args.output}")


def _finish(args, mesh, ndof, res, t0):
    """Report and write (rank 0 alone on a sharded run); the exit code."""
    from pfemfort_tpu_torch.parallel import multihost

    if multihost.is_coordinator():
        _report(mesh, ndof, res, t0)
        _write_output(args, mesh, ndof, res)
    if args.shards and args.shards > 1:
        multihost.shutdown()
    return 0 if res.stats.converged else 1


def _solver_opts(args):
    """PETSc-options-file parity: -ksp_type/-pc_type/-ksp_rtol etc.
    (solverpetsc.F:198,209 let the reference switch solvers this way)."""
    if getattr(args, "options_file", None):
        from pfemfort_tpu_torch.config import SolverOptions
        o = SolverOptions.from_options_file(args.options_file)
        args.rtol = o.rtol
        if o.ksp_type in ("cg", "bicgstab", "gmres"):
            args.ksp = o.ksp_type
        if hasattr(args, "precond") and o.pc_type != "jacobi":
            # -pc_type ilu/icc -> ic0, gamg -> amg, hypre -> mg (config.py
            # aliases); block_jacobi -> the sharded bjacobi route
            args.precond = {"block_jacobi": "bjacobi"}.get(o.pc_type,
                                                           o.pc_type)
    return args


def cmd_poisson(args):
    from pfemfort_tpu_torch.drivers.poisson import solve_poisson
    from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices

    _solver_opts(args)
    sharded = args.shards and args.shards > 1
    if sharded:
        rc = _launch_ranks(args, args.argv)
        if rc is not None:
            return rc
    else:
        device, dtype = _device(args)
    mesh, dbc, _ = _read(args)
    t0 = time.perf_counter()
    if sharded:
        src = args.source
        if src is None:
            src = -6.0 if mesh.etype == "tetra4" else 0.0
        res = _solve_sharded(args, mesh, 1, dbc, lambda c:
                             poisson_element_matrices(c, mesh.etype,
                                                      source=src))
    else:
        res = solve_poisson(mesh, dbc, rtol=args.rtol, method=args.ksp,
                            source=args.source, bc_mode=args.bc_mode,
                            precond=args.precond, refine=args.refine,
                            matrix_free=args.matrix_free, device=device,
                            dtype=dtype)
    return _finish(args, mesh, 1, res, t0)


def cmd_elasticity(args):
    from pfemfort_tpu_torch.drivers.elasticity import solve_elasticity
    from pfemfort_tpu_torch.elements.elasticity import dmat_3d, \
        dmat_plane_strain, dmat_plane_stress, elasticity_stiffness

    _solver_opts(args)
    # --precond: the sharded solve's preconditioner (bjacobi when not
    # given), or the single-device solve's (jacobi when not given; one the
    # reduced solve does not take is refused)
    sharded = args.shards and args.shards > 1
    if args.precond is None:
        args.precond = "bjacobi" if sharded else "jacobi"
    elif not sharded and args.precond not in _SINGLE_ELASTICITY_PRECONDS:
        raise SystemExit(f"--precond {args.precond}: a single-device "
                         "elasticity solve takes one of "
                         f"{', '.join(_SINGLE_ELASTICITY_PRECONDS)}")
    if sharded:
        rc = _launch_ranks(args, args.argv)
        if rc is not None:
            return rc
    else:
        device, dtype = _device(args)
    mesh, dbc, fbc = _read(args)
    t0 = time.perf_counter()
    if sharded:
        if mesh.ndim == 2:
            D = dmat_plane_stress(args.E, args.nu) \
                if args.plane == "stress" else \
                dmat_plane_strain(args.E, args.nu)
        else:
            D = dmat_3d(args.E, args.nu)
        res = _solve_sharded(args, mesh, mesh.ndim, dbc, lambda c:
                             elasticity_stiffness(c, mesh.etype, D), fbc)
    else:
        res = solve_elasticity(
            mesh, dbc, args.E, args.nu, force_bc=fbc,
            bforce=None, plane=args.plane, rtol=args.rtol,
            method=args.ksp, refine=args.refine, precond=args.precond,
            device=device, dtype=dtype)
    return _finish(args, mesh, mesh.ndim, res, t0)


def cmd_explicit(args):
    from pfemfort_tpu_torch.drivers import presets as P
    from pfemfort_tpu_torch.dynamics.explicit import explicit_dynamics

    preset = {
        "tria": P.TRIA_EXPLICIT,
        "quad": P.QUAD_EXPLICIT,
        "prism": P.PRISM_EXPLICIT,
        "tria6": P.TRIA6_EXPLICIT,
    }[args.preset]
    device, dtype = _device(args)
    mesh, dbc, fbc = _read(args)
    if mesh.etype != preset.etype:
        raise SystemExit(f"mesh is {mesh.etype}, preset wants {preset.etype}")

    nsteps = args.nsteps or preset.nsteps
    dt = args.dt or preset.dt
    ndim = mesh.ndim
    bforce = torch.tensor(preset.bforce, dtype=dtype, device=device)
    pulse_t = None if preset.pulse_t is None else \
        torch.tensor(preset.pulse_t, dtype=dtype, device=device)

    def bforce_fn(t):
        if pulse_t is None:
            return bforce
        return bforce * torch.where(t <= pulse_t, 1.0, 0.0)

    snapshot_cb = None
    if args.vtk_every and args.output:
        from pfemfort_tpu_torch.io.vtk import write_vtk
        stem = args.output[:-4] if args.output.endswith(".vtk") \
            else args.output

        def snapshot_cb(step, disp_full):
            path = f"{stem}-{step:05d}.vtk"
            write_vtk(path, mesh, disp_full, ndim)
            print(f" Wrote {path}")

    t0 = time.perf_counter()
    res = explicit_dynamics(
        mesh, dbc, preset.E, preset.nu, preset.dens, dt, nsteps,
        bforce_fn=bforce_fn, force_bc=fbc,
        probe_dofs=args.probe or preset.probe_dofs,
        thickness=preset.thickness, use_hourglass=preset.use_hourglass,
        snapshot_every=args.vtk_every, snapshot_cb=snapshot_cb,
        device=device, dtype=dtype)
    print(f" {nsteps} steps in {time.perf_counter() - t0:.3f} seconds")
    if (args.probe or preset.probe_dofs):
        # reference writes timeNow disp... velo... (triaelasticityexplicit.F:1098)
        with open(args.probe_out, "w") as f:
            for t, row in zip(res.times, res.probe_history):
                f.write(" ".join(map(str, [t] + list(row))) + "\n")
        print(f" Wrote {args.probe_out}")
    if args.output:
        from pfemfort_tpu_torch.io.vtk import write_vtk

        write_vtk(args.output, mesh, res.disp, ndim)
        print(f" Wrote {args.output}")
    return 0


def cmd_cfd(args):
    """Lid-driven-cavity style incompressible NS (the working version of the
    reference's abandoned cfdexplicittria6node)."""
    import numpy as np

    from pfemfort_tpu_torch.cfd.navierstokes import fractional_step_ns

    device, dtype = _device(args)
    mesh, vbc, _ = _read(args)
    t0 = time.perf_counter()
    res = fractional_step_ns(mesh, vbc, nu_visc=args.nu_visc, dt=args.dt,
                             nsteps=args.nsteps, device=device, dtype=dtype)
    print(f" {args.nsteps} steps in {time.perf_counter() - t0:.3f} seconds; "
          f"final max|div u| = {float(res.div_history[-1]):.3e}")
    if args.output:
        from pfemfort_tpu_torch.io.vtk import write_vtk
        if mesh.ndim == 2:
            # 2D: pack (u, v, p) as a 3-vector (ParaView-friendly)
            sol = np.concatenate(
                [res.velocity, res.pressure[:, None]], axis=1).reshape(-1)
            write_vtk(args.output, mesh, sol, 3)
            print(f" Wrote {args.output} (vector = u,v,p)")
        else:
            write_vtk(args.output, mesh, res.velocity.reshape(-1),
                      mesh.ndim)
            print(f" Wrote {args.output} (vector = u,v,w)")
    return 0


def cmd_genmesh(args):
    from pfemfort_tpu_torch.mesh import generate
    from pfemfort_tpu_torch.mesh import io as mesh_io

    if args.shape == "tet":
        mesh, dbc = generate.box_tet(
            args.x0, args.x1, args.nex, args.y0, args.y1, args.ney,
            args.z0, args.z1, args.nez)
        mesh_io.write_dat(args.out, mesh, dirichlet=dbc)
    else:
        mesh = generate.rect_tria(args.x0, args.x1, args.nex,
                                  args.y0, args.y1, args.ney)
        mesh_io.write_dat(args.out, mesh)
    print(f" Wrote {args.out}-nodes.dat / -elems.dat"
          + (" / -DirichBC.dat" if args.shape == "tet" else ""))
    return 0


def cmd_partition(args):
    import numpy as np

    from pfemfort_tpu_torch.mesh import io as mesh_io
    from pfemfort_tpu_torch.parallel.partition import partition_elements

    mesh = mesh_io.read_mesh(args.nodes, args.elems)
    part = partition_elements(mesh, args.nparts, method=args.method)
    counts = np.bincount(part, minlength=args.nparts)
    print(f" Partitioned {mesh.n_elem} elements into {args.nparts} parts; "
          f"sizes {counts.tolist()}")
    if args.output:
        from pfemfort_tpu_torch.io.vtk import write_vtk

        write_vtk(args.output, mesh, np.zeros(mesh.n_node), 1,
                  elem_procid=part)
        print(f" Wrote {args.output}")
    return 0


def cmd_vtktovtu(args):
    from pfemfort_tpu_torch.io.vtk import vtk_to_vtu

    vtk_to_vtu(args.input, args.out)
    print(f" Wrote {args.out}")
    return 0


def cmd_bench(args):
    from pfemfort_tpu_torch import bench

    return bench.main([str(args.n), str(args.n_large),
                       str(args.n_large_unstr), "--device", args.device,
                       "--detail", args.detail, "--budget-s",
                       str(args.budget_s)])


def build_parser():
    p = argparse.ArgumentParser(
        prog="pfemfort_tpu_torch",
        description="FEM solvers on PyTorch and CUDA (PFEMFort capability "
                    "set)")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_files(sp, force=False):
        sp.add_argument("nodes")
        sp.add_argument("elems")
        sp.add_argument("dbc")
        if force:
            sp.add_argument("fbc", nargs="?", default=None)
        sp.add_argument("-o", "--output", default=None,
                        help="legacy VTK output path")
        sp.add_argument("--options-file", default=None,
                        help="PETSc-style options file (-ksp_type, "
                             "-pc_type, -ksp_rtol, ...)")
        sp.add_argument("--device", default="cuda",
                        help="torch device to solve on (default cuda; "
                             "cpu runs the kernels' plain versions)")
        sp.add_argument("--dtype", choices=sorted(_DTYPES),
                        default="float32", help="working precision")

    sp = sub.add_parser("poisson", help="implicit Poisson (2D/3D)")
    add_files(sp)
    sp.add_argument("--rtol", type=float, default=1e-8)
    sp.add_argument("--ksp", choices=["cg", "bicgstab", "gmres"],
                    default="cg")
    sp.add_argument("--source", type=float, default=None,
                    help="volume source (default: 0 in 2D, -6 for tetra)")
    sp.add_argument("--shards", type=int, default=0,
                    help="solve on N ranks (0 = single device): the "
                         "per-rank DIA or ELL route, one card per rank")
    sp.add_argument("--bc-mode", choices=["reduced", "full"],
                    default="reduced",
                    help="reduced = BC-eliminated system (impl1/2); "
                         "full = MatZeroRows identity rows (impl3)")
    sp.add_argument("--precond",
                    choices=["jacobi", "cheby", "ic0", "amg", "mg"],
                    default="jacobi",
                    help="cheby = Chebyshev polynomial, ic0 = IC(0), amg = "
                         "smoothed aggregation (reduced mode); mg = "
                         "geometric multigrid (structured meshes, "
                         "--bc-mode full)")
    sp.add_argument("--refine", action="store_true",
                    help="float32 inner CG refined to a TRUE float64 rtol")
    sp.add_argument("--matrix-free", action="store_true",
                    help="assembly-free operator (Jacobi-CG)")
    sp.set_defaults(fn=cmd_poisson)

    sp = sub.add_parser("elasticity", help="implicit linear elasticity")
    add_files(sp, force=True)
    sp.add_argument("--E", type=float, default=240.565)
    sp.add_argument("--nu", type=float, default=0.3)
    sp.add_argument("--plane", choices=["stress", "strain"],
                    default="stress")
    sp.add_argument("--rtol", type=float, default=1e-8)
    sp.add_argument("--ksp", choices=["cg", "bicgstab", "gmres"],
                    default="cg")
    sp.add_argument("--shards", type=int, default=0,
                    help="solve on N ranks (0 = single device): the "
                         "per-rank DIA or ELL route, one card per rank")
    sp.add_argument("--precond",
                    choices=["jacobi", "bjacobi", "ic0", "amg", "mg"],
                    default=None,
                    help="sharded solve: jacobi, bjacobi (the default), "
                         "ic0, amg or mg; single device: jacobi (the "
                         "default), ic0 or amg on the reduced system")
    sp.add_argument("--refine", action="store_true",
                    help="float32 inner CG refined to a TRUE float64 rtol")
    sp.set_defaults(fn=cmd_elasticity)

    sp = sub.add_parser("explicit", help="explicit central-difference dynamics")
    add_files(sp, force=True)
    sp.add_argument("--preset", choices=["tria", "quad", "prism", "tria6"],
                    required=True)
    sp.add_argument("--nsteps", type=int, default=None)
    sp.add_argument("--dt", type=float, default=None)
    sp.add_argument("--probe", type=int, nargs="*", default=None,
                    help="0-based global node-dof indices to record")
    sp.add_argument("--probe-out", default="solnoutput.dat")
    sp.add_argument("--vtk-every", type=int, default=0,
                    help="write <output-stem>-NNNNN.vtk every k steps (the "
                         "reference's Elasticity-soln-NNNNN.vtk series)")
    sp.set_defaults(fn=cmd_explicit)

    sp = sub.add_parser("cfd", help="incompressible NS fractional step")
    add_files(sp)
    sp.add_argument("--nu-visc", type=float, default=0.05)
    sp.add_argument("--dt", type=float, default=2e-3)
    sp.add_argument("--nsteps", type=int, default=500)
    sp.set_defaults(fn=cmd_cfd)

    sp = sub.add_parser("genmesh", help="generate structured meshes")
    sp.add_argument("shape", choices=["tet", "tria"])
    sp.add_argument("x0", type=float)
    sp.add_argument("x1", type=float)
    sp.add_argument("nex", type=int)
    sp.add_argument("y0", type=float)
    sp.add_argument("y1", type=float)
    sp.add_argument("ney", type=int)
    sp.add_argument("z0", type=float, nargs="?")
    sp.add_argument("z1", type=float, nargs="?")
    sp.add_argument("nez", type=int, nargs="?")
    sp.add_argument("-o", "--out", required=True, help="output prefix")
    sp.set_defaults(fn=cmd_genmesh)

    sp = sub.add_parser("partition", help="partition a mesh")
    sp.add_argument("nodes")
    sp.add_argument("elems")
    sp.add_argument("--nparts", type=int, required=True)
    sp.add_argument("--method", choices=["rcb", "greedy"], default="rcb")
    sp.add_argument("-o", "--output", default=None)
    sp.set_defaults(fn=cmd_partition)

    sp = sub.add_parser("vtktovtu", help="legacy VTK -> XML .vtu")
    sp.add_argument("input")
    sp.add_argument("out")
    sp.set_defaults(fn=cmd_vtktovtu)

    from pfemfort_tpu_torch import bench

    sp = sub.add_parser("bench", help="the benchmark harness (bench.py)")
    sp.add_argument("n", type=int, nargs="?", default=72)
    sp.add_argument("n_large", type=int, nargs="?", default=200)
    sp.add_argument("n_large_unstr", type=int, nargs="?", default=160)
    bench.add_options(sp)
    sp.set_defaults(fn=cmd_bench)
    return p


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    args.argv = argv
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
