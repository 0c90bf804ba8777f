"""Port parity: the command line `python -m pfemfort_tpu_torch`.

Each ported subcommand runs in both packages on the same `.dat` files (the
JAX CLI in float64 in this process, the port's with `--device cpu --dtype
float64`): the printed iteration counts and the exit codes must be equal,
the VTK solutions equal to the writer's 6 decimals (1e-6 absolute, plus
one unit of rounding), and the probe histories equal to a relative 1e-9.
BiCGStab on the elasticity system is the exception: its count moves by up
to 2 when b changes by a relative 1e-15, in the JAX package alone (dense
against DIA operator, or b perturbed: 84 to 87 iterations at rtol 1e-8),
so the two counts may differ by 2.
The preconditioners, the full system (`--bc-mode full`), `--refine`,
`--matrix-free`, `cfd`, `partition` and `--shards N` (the per-rank DIA
route on N gloo ranks, which the port's CLI starts under torchrun) run like the JAX
CLI; `bench` runs the port's bench harness (tests/test_torch_bench.py
holds its stages).  One run goes through a fresh process that never
imports JAX.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pfemfort_tpu.drivers.cli import main as j_main
from pfemfort_tpu_torch.drivers.cli import main as t_main

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu", "--dtype", "float64"]
VTK_TOL = 2e-6


def _iters(out):
    m = re.search(r"Convergence in (\d+) iterations", out)
    assert m, out
    return int(m.group(1))


def _vtk_solution(path):
    text = Path(path).read_text()
    body = text.split("POINT_DATA")[1].split("\n", 2)[2]
    if body.startswith("LOOKUP_TABLE"):
        body = body.split("\n", 1)[1]
    return np.array(body.split(), dtype=np.float64)


def _run_both(capsys, argv_j, argv_t):
    rc_j = j_main(argv_j)
    out_j = capsys.readouterr().out
    rc_t = t_main(argv_t)
    out_t = capsys.readouterr().out
    assert rc_j == rc_t
    return out_j, out_t


@pytest.fixture()
def tet_prefix(tmp_path):
    rc = t_main(["genmesh", "tet", "0", "1", "4", "0", "1", "3",
                 "0", "1", "3", "-o", str(tmp_path / "box")])
    assert rc == 0
    return str(tmp_path / "box")


def _files(prefix, force=False):
    out = [prefix + "-nodes.dat", prefix + "-elems.dat",
           prefix + "-DirichBC.dat"]
    return out + [prefix + "-ForceBC.dat"] if force else out


@pytest.fixture()
def cantilever(tmp_path):
    """A 2D rect_tria cantilever written by the port's genmesh: x=0 clamped,
    unit +x loads on the x=2 edge."""
    prefix = str(tmp_path / "beam")
    assert t_main(["genmesh", "tria", "0", "2", "12", "0", "1", "6",
                   "-o", prefix]) == 0
    X = np.loadtxt(prefix + "-nodes.dat")[:, 1:]
    left = np.nonzero(X[:, 0] == 0.0)[0] + 1
    right = np.nonzero(X[:, 0] == 2.0)[0] + 1
    np.savetxt(prefix + "-DirichBC.dat",
               [(n, c, 0.0) for n in left for c in (1, 2)], fmt="%d %d %.1f")
    np.savetxt(prefix + "-ForceBC.dat", [(n, 1, 1.0) for n in right],
               fmt="%d %d %.1f")
    return prefix


@pytest.mark.parametrize("shape,args", [
    ("tet", ["0", "1", "3", "0", "2", "2", "0", "1", "4"]),
    ("tria", ["0", "2", "5", "0", "1", "3"])])
def test_genmesh_writes_the_jax_files(tmp_path, shape, args):
    pj, pt_ = str(tmp_path / "j"), str(tmp_path / "t")
    assert j_main(["genmesh", shape, *args, "-o", pj]) == 0
    assert t_main(["genmesh", shape, *args, "-o", pt_]) == 0
    parts = ["nodes", "elems"] + (["DirichBC"] if shape == "tet" else [])
    for part in parts:
        assert Path(f"{pt_}-{part}.dat").read_text() == \
            Path(f"{pj}-{part}.dat").read_text()


@pytest.mark.parametrize("extra", [[], ["--ksp", "bicgstab"],
                                   ["--ksp", "gmres"], ["--rtol", "1e-6"]])
def test_poisson_matches_jax(tet_prefix, tmp_path, capsys, extra):
    vj, vt = str(tmp_path / "j.vtk"), str(tmp_path / "t.vtk")
    out_j, out_t = _run_both(
        capsys, ["poisson", *_files(tet_prefix), "-o", vj, *extra],
        ["poisson", *_files(tet_prefix), "-o", vt, *extra, *CPU])
    assert _iters(out_t) == _iters(out_j)
    assert "Mesh statistics: nElem 216  nNode 80  npElem 4  ndof 1" in out_t
    assert np.abs(_vtk_solution(vt) - _vtk_solution(vj)).max() <= VTK_TOL


@pytest.mark.parametrize("extra", [[], ["--ksp", "bicgstab"],
                                   ["--plane", "strain", "--E", "200"],
                                   ["--precond", "ic0"]])
def test_elasticity_matches_jax(cantilever, tmp_path, capsys, extra):
    """With --precond ic0 the JAX CLI's single-device elasticity still runs
    Jacobi, and the port's runs IC(0) on the reduced system: its count is
    the JAX package's own IC(0) solve of the same files (within one: the
    port's pattern assembly sums each entry in another order than JAX's
    segment_sum), below the JAX CLI's Jacobi count, and both solutions
    agree to the writer's digits."""
    vj, vt = str(tmp_path / "j.vtk"), str(tmp_path / "t.vtk")
    files = _files(cantilever, force=True)
    out_j, out_t = _run_both(
        capsys, ["elasticity", *files, "-o", vj, *extra],
        ["elasticity", *files, "-o", vt, *extra, *CPU])
    if "ic0" in extra:
        assert abs(_iters(out_t) - _jax_ic0_iters(files)) <= 1
        assert _iters(out_t) < _iters(out_j)
    else:
        slack = 2 if "bicgstab" in extra else 0
        assert abs(_iters(out_t) - _iters(out_j)) <= slack
    assert "npElem 3  ndof 2" in out_t
    uj, ut = _vtk_solution(vj), _vtk_solution(vt)
    assert np.abs(ut - uj).max() <= VTK_TOL and np.abs(uj).max() > 0.01


def _jax_ic0_iters(files):
    """The JAX package's IC(0)-CG count on the cantilever's files, as its
    CLI would solve them with the preconditioner passed on."""
    from pfemfort_tpu.drivers.common import solve_implicit as j_solve
    from pfemfort_tpu.elements import elasticity as je
    from pfemfort_tpu.mesh import io as j_io

    mesh = j_io.read_mesh(files[0], files[1])
    D = je.dmat_plane_stress(240.565, 0.3)
    res = j_solve(mesh, 2, j_io.read_bcs(files[2]),
                  lambda c: je.elasticity_stiffness(c, mesh.etype, D),
                  force_bc=j_io.read_bcs(files[3]), rtol=1e-8,
                  precond="ic0")
    return int(res.stats.iters)


@pytest.mark.parametrize("precond", ["bjacobi", "mg"])
def test_elasticity_refuses_a_preconditioner_it_lacks(cantilever, precond):
    """Without --shards the elasticity CLI preconditions the reduced
    system; a choice that system does not take is refused."""
    with pytest.raises(SystemExit, match="jacobi, ic0, amg"):
        t_main(["elasticity", *_files(cantilever, force=True), "--precond",
                precond, *CPU])


def test_elasticity_options_file_matches_jax(cantilever, tmp_path, capsys):
    opts = tmp_path / "petsc_options.dat"
    opts.write_text("# solver\n-ksp_type bcgs\n-pc_type jacobi\n"
                    "-ksp_rtol 1e-9\n")
    files = _files(cantilever, force=True)
    out_j, out_t = _run_both(
        capsys, ["elasticity", *files, "--options-file", str(opts)],
        ["elasticity", *files, "--options-file", str(opts), *CPU])
    assert abs(_iters(out_t) - _iters(out_j)) <= 2      # BiCGStab


@pytest.mark.parametrize("vtk_every", [0, 4])
def test_explicit_matches_jax(tmp_path, capsys, vtk_every):
    from pfemfort_tpu_torch.mesh import generate, io as mesh_io

    mesh = generate.rect_tria(0, 1, 6, 0, 1, 3)
    left = np.nonzero(mesh.coords[:, 0] == 0.0)[0]
    dbc = np.array([[n, c, 0.0] for n in left for c in (0, 1)])
    prefix = str(tmp_path / "m")
    mesh_io.write_dat(prefix, mesh, dirichlet=dbc)
    common = ["explicit", *_files(prefix), "--preset", "tria", "--nsteps",
              "10", "--dt", "0.02", "--probe", "20", "21",
              "--vtk-every", str(vtk_every)]
    pj, pt_ = str(tmp_path / "pj.dat"), str(tmp_path / "pt.dat")
    vj, vt = str(tmp_path / "j.vtk"), str(tmp_path / "t.vtk")
    out_j, out_t = _run_both(
        capsys, [*common, "--probe-out", pj, "-o", vj],
        [*common, "--probe-out", pt_, "-o", vt, *CPU])
    hj, ht = np.loadtxt(pj), np.loadtxt(pt_)
    assert ht.shape == hj.shape == (10, 5)
    np.testing.assert_array_equal(ht[:, 0], hj[:, 0])
    assert np.abs(ht - hj).max() <= 1e-9 * np.abs(hj).max()
    assert np.abs(_vtk_solution(vt) - _vtk_solution(vj)).max() <= VTK_TOL
    snaps = sorted(p.name for p in tmp_path.glob("t-*.vtk"))
    assert snaps == ([] if not vtk_every else ["t-00004.vtk", "t-00008.vtk",
                                               "t-00010.vtk"])
    assert snaps == sorted(p.name.replace("j-", "t-")
                           for p in tmp_path.glob("j-*.vtk"))
    assert out_t.count("Wrote") == out_j.count("Wrote")


def test_explicit_refuses_a_mesh_of_another_element(tet_prefix):
    with pytest.raises(SystemExit, match="preset wants"):
        t_main(["explicit", *_files(tet_prefix), "--preset", "tria",
                "--nsteps", "2", *CPU])


def test_vtktovtu_matches_jax(tet_prefix, tmp_path, capsys):
    vtk = str(tmp_path / "s.vtk")
    assert t_main(["poisson", *_files(tet_prefix), "-o", vtk, *CPU]) == 0
    uj, ut = str(tmp_path / "j.vtu"), str(tmp_path / "t.vtu")
    _run_both(capsys, ["vtktovtu", vtk, uj], ["vtktovtu", vtk, ut])
    assert Path(ut).read_text() == Path(uj).read_text()


@pytest.mark.parametrize("argv,item", [
    (["poisson", "--bc-mode", "full"], "A.6"),
    (["poisson", "--precond", "cheby"], "A.6"),
    (["poisson", "--refine"], "A.7"),
    (["poisson", "--matrix-free"], "A.8"),
    (["poisson", "--shards", "2"], "A.9"),
    (["elasticity", "--shards", "4"], "A.9"),
    (["elasticity", "--refine"], "A.7"),
    (["cfd"], "A.8"),
])
def test_options_outside_the_slice_raise(tet_prefix, cantilever, tmp_path,
                                         capfd, argv, item):
    """Options once outside the port, each ported since, run like the JAX
    CLI: those of A.6, A.7 and A.8 on the box (Poisson), the cantilever
    (elasticity) or the box's files with its Dirichlet rows as velocity BCs
    (cfd); A.9's `--shards N` on meshes whose every rank holds at least a
    halo's width of rows (the per-rank DIA route): Poisson on a 4x4x8 box,
    3D elasticity on a clamped 3x3x16 box with a point load, with each
    element's rank written as the VTK procid.  The refined elasticity count
    is a sum of float32 inner CG counts, which move with the order of the
    sums, so it may differ by 10%; sharded elasticity CG by 2 (its slow
    tail moves with round-off).  capfd: the sharded ranks are processes
    that write to the descriptors themselves."""
    cmd, opts = argv[0], argv[1:]
    if item == "A.9":
        _sharded_matches_jax(cmd, opts, tmp_path, capfd)
        return
    if cmd == "cfd":
        _cfd_matches_jax(_files(tet_prefix), tmp_path, capfd)
        return
    files = _files(cantilever, force=True) if cmd == "elasticity" \
        else _files(tet_prefix)
    vj, vt = str(tmp_path / "j.vtk"), str(tmp_path / "t.vtk")
    out_j, out_t = _run_both(capfd, [cmd, *files, *opts, "-o", vj],
                             [cmd, *files, *opts, "-o", vt, *CPU])
    slack = int(0.1 * _iters(out_j)) if cmd == "elasticity" else 0
    assert abs(_iters(out_t) - _iters(out_j)) <= slack
    assert np.abs(_vtk_solution(vt) - _vtk_solution(vj)).max() <= VTK_TOL


def _sharded_case(cmd, tmp_path):
    """.dat files of a mesh the per-rank DIA route takes at 2 and 4 ranks."""
    from pfemfort_tpu_torch.mesh import generate, io as mesh_io

    prefix = str(tmp_path / f"{cmd}-sharded")
    if cmd == "poisson":
        mesh, dbc = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 8)
        mesh_io.write_dat(prefix, mesh, dirichlet=dbc)
        return _files(prefix)
    mesh, _ = generate.box_tet(0, 1, 3, 0, 1, 3, 0, 1, 16)
    base = np.nonzero(mesh.coords[:, 2] == 0.0)[0]
    dbc = np.array([[n, d, 0.0] for n in base for d in (0, 1, 2)])
    tip = int(np.argmax(mesh.coords[:, 2]))
    mesh_io.write_dat(prefix, mesh, dirichlet=dbc,
                      force=np.array([[tip, 0, 1.0]]))
    return _files(prefix, force=True)


def _sharded_matches_jax(cmd, opts, tmp_path, capfd):
    files = _sharded_case(cmd, tmp_path)
    vj, vt = str(tmp_path / "j.vtk"), str(tmp_path / "t.vtk")
    out_j, out_t = _run_both(capfd, [cmd, *files, *opts, "-o", vj],
                             [cmd, *files, *opts, "-o", vt, *CPU])
    slack = 2 if cmd == "elasticity" else 0
    assert abs(_iters(out_t) - _iters(out_j)) <= slack
    assert out_t.count("Convergence in") == 1       # rank 0 alone reports
    uj = _vtk_solution(vj)
    assert np.abs(_vtk_solution(vt) - uj).max() <= VTK_TOL * max(
        1.0, np.abs(uj).max())
    cells = lambda p: Path(p).read_text().split("SCALARS procid int 1")[1]
    assert cells(vt) == cells(vj)


def _vtk_vector(path, ncomp):
    return _vtk_solution(path).reshape(-1, ncomp)


def _cfd_matches_jax(files, tmp_path, capsys, nsteps="15"):
    """The cfd subcommand in both packages: the printed final max|div u|
    and the VTK velocity (and 2D pressure) agree."""
    vj, vt = str(tmp_path / "cj.vtk"), str(tmp_path / "ct.vtk")
    argv = ["cfd", *files, "--nsteps", nsteps, "--dt", "1e-3"]
    out_j, out_t = _run_both(capsys, [*argv, "-o", vj],
                             [*argv, "-o", vt, *CPU])
    div = lambda out: float(re.search(r"max\|div u\| = (\S+)", out)[1])
    assert abs(div(out_t) - div(out_j)) <= 1e-3 * div(out_j)
    assert f"{nsteps} steps in" in out_t and "Wrote" in out_t
    assert np.abs(_vtk_solution(vt) - _vtk_solution(vj)).max() <= VTK_TOL


def test_cfd_on_a_renumbered_cavity_matches_jax(tmp_path, capsys):
    """A 2D lid-driven cavity written as .dat files with its nodes renumbered
    (so the pressure operator is ELL): (u, v, p) as the JAX CLI writes it."""
    from pfemfort_tpu.mesh import generate as jgen
    from pfemfort_tpu.mesh import io as jio

    mesh = jgen.rect_tria(0, 1, 10, 0, 1, 10)
    perm = np.random.default_rng(0).permutation(mesh.n_node)
    mesh = mesh.renumbered(perm.astype(np.int64))
    x, y = mesh.coords.T
    wall = np.isclose(x, 0) | np.isclose(x, 1) | np.isclose(y, 0)
    lid = np.isclose(y, 1) & ~wall
    rows = [[n, c, 1.0 if (lid[n] and c == 0) else 0.0]
            for n in np.nonzero(wall | lid)[0] for c in (0, 1)]
    prefix = str(tmp_path / "cavity")
    jio.write_dat(prefix, mesh, dirichlet=np.asarray(rows, np.float64))
    _cfd_matches_jax(_files(prefix), tmp_path, capsys, nsteps="20")


@pytest.mark.parametrize("method", ["rcb", "greedy"])
def test_partition_matches_jax(tet_prefix, tmp_path, capsys, method):
    """The partition subcommand: the same part sizes printed and the same
    per-element part ids in the VTK file."""
    pj, ptv = str(tmp_path / "pj.vtk"), str(tmp_path / "pt.vtk")
    argv = ["partition", *_files(tet_prefix)[:2], "--nparts", "3",
            "--method", method]
    out_j, out_t = _run_both(capsys, [*argv, "-o", pj], [*argv, "-o", ptv])
    assert out_t.replace(ptv, "") == out_j.replace(pj, "")
    assert "Partitioned 216 elements into 3 parts" in out_t
    cells = lambda p: Path(p).read_text().split("SCALARS procid int 1")[1]
    assert cells(ptv) == cells(pj)


@pytest.mark.parametrize("extra", [
    ["--bc-mode", "full", "--precond", "mg"],
    ["--bc-mode", "full", "--ksp", "gmres"],
    ["--precond", "cheby"], ["--precond", "ic0"], ["--precond", "amg"],
    ["--refine"], ["--refine", "--rtol", "1e-11"]])
def test_poisson_preconditioners_match_jax(tmp_path, capsys, extra):
    """The preconditioners, the full system and refinement through the
    command line, on a box large enough for SA-AMG and for two multigrid
    levels (17^3 nodes: the dense coarsest level holds at most 4,096)."""
    prefix = str(tmp_path / "box")
    assert t_main(["genmesh", "tet", "0", "1", "16", "0", "1", "16",
                   "0", "1", "16", "-o", prefix]) == 0
    vj, vt = str(tmp_path / "j.vtk"), str(tmp_path / "t.vtk")
    out_j, out_t = _run_both(
        capsys, ["poisson", *_files(prefix), "-o", vj, *extra],
        ["poisson", *_files(prefix), "-o", vt, *extra, *CPU])
    assert _iters(out_t) == _iters(out_j)
    assert np.abs(_vtk_solution(vt) - _vtk_solution(vj)).max() <= VTK_TOL


@pytest.mark.parametrize("pc_type,precond", [("gamg", "amg"), ("ilu", "ic0"),
                                             ("hypre", "mg")])
def test_options_file_pc_type_matches_jax(tet_prefix, tmp_path, capsys,
                                          pc_type, precond):
    """-pc_type in a PETSc options file maps as in the JAX package (gamg ->
    amg, ilu -> ic0, hypre -> mg) and the solve follows it."""
    from pfemfort_tpu.config import SolverOptions as JOpts
    from pfemfort_tpu_torch.config import SolverOptions as TOpts

    text = f"-ksp_type cg\n-pc_type {pc_type}\n-ksp_rtol 1e-10\n"
    assert TOpts.from_options(text).pc_type == precond
    assert JOpts.from_options(text).pc_type == precond
    opts = tmp_path / "petsc_options.dat"
    opts.write_text(text)
    argv = ["poisson", *_files(tet_prefix), "--options-file", str(opts)]
    out_j, out_t = _run_both(capsys, argv, [*argv, *CPU])
    assert _iters(out_t) == _iters(out_j)


@pytest.mark.parametrize("argv,item", [
    (["partition", "N", "E", "--nparts", "2"], "A.9"),
    (["bench", "8"], "A.10")])
def test_subcommands_outside_the_slice_raise(tet_prefix, tmp_path, capsys,
                                             argv, item):
    """The subcommands once outside the port's slices now run: partition
    (ROADMAP A.9) prints the JAX CLI's part sizes; bench (A.10) runs the
    port's bench harness (n=8 here, on the CPU) and prints its result line
    last, every stage true."""
    if argv[0] == "partition":
        argv = ["partition", *_files(tet_prefix)[:2], *argv[3:]]
        out_j, out_t = _run_both(capsys, argv, argv)
        assert out_t == out_j and "into 2 parts" in out_t
        return
    rc = t_main([*argv, "0", "0", "--device", "cpu", "--detail",
                 str(tmp_path / "detail.json")])
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 0 and last["stages"]["flagship"]
    assert all(last["stages"].values())
    assert last["metric"] == "spmv_nnz_per_s" and last["value"] > 0


def test_cuda_device_without_a_card_fails(tet_prefix):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="cuda"):
        t_main(["poisson", *_files(tet_prefix)])


def test_cli_runs_without_jax_in_a_fresh_process(cantilever, tmp_path):
    vtk = str(tmp_path / "fresh.vtk")
    argv = ["elasticity", *_files(cantilever, force=True), "-o", vtk, *CPU]
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['pfemfort_tpu_torch'] + {argv!r}\n"
        "try:\n"
        "    runpy.run_module('pfemfort_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'pfemfort_tpu.')) or m == 'pfemfort_tpu')\n"
        "print('RESULT', rc, bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    assert "Convergence in" in out
    assert out.strip().splitlines()[-1] == "RESULT 0 []"
    assert np.abs(_vtk_solution(vtk)).max() > 0.01
