"""Port parity: `--shards N` on the port's command line.

Launched by hand (no torchrun environment), `python -m pfemfort_tpu_torch
poisson|elasticity ... --shards N --device cpu` re-runs itself as N gloo
ranks under torchrun; rank 0 alone prints the report and writes
the VTK file, with each element's rank as its procid.  Against the JAX
CLI's `--shards N` in this process (virtual CPU devices), float64: the
printed iteration counts, the VTK solutions (the writer's 6 decimals) and
the procid cells.  `--device cuda` needs one card per rank, a mesh
without a per-rank DIA layout solves on the ELL route, and `--precond
mg|amg` take the distributed multigrid routes as the JAX CLI does.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pfemfort_tpu.drivers.cli import main as j_main
from pfemfort_tpu_torch.drivers.cli import main as t_main
from pfemfort_tpu_torch.mesh import generate, io as mesh_io

REPO = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu", "--dtype", "float64"]
VTK_TOL = 2e-6


def _files(prefix, force=False):
    out = [prefix + s for s in ("-nodes.dat", "-elems.dat", "-DirichBC.dat")]
    return out + [prefix + "-ForceBC.dat"] if force else out


def _iters(out):
    m = re.search(r"Convergence in (\d+) iterations", out)
    assert m, out
    return int(m.group(1))


def _solution(path):
    text = Path(path).read_text()
    body = text.split("POINT_DATA")[1].split("\n", 2)[2]
    if body.startswith("LOOKUP_TABLE"):
        body = body.split("\n", 1)[1]
    return np.array(body.split(), dtype=np.float64)


def _cells(path):
    return Path(path).read_text().split("SCALARS procid int 1")[1]


def _procids(path):
    """The per-element rank ids of the VTK file's procid cell data."""
    body = _cells(path).split("LOOKUP_TABLE default")[1]
    return np.array(body.split("POINT_DATA")[0].split(), dtype=np.int64)


@pytest.fixture()
def box(tmp_path):
    mesh, dbc = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 8)
    prefix = str(tmp_path / "box")
    mesh_io.write_dat(prefix, mesh, dirichlet=dbc)
    return _files(prefix)


@pytest.fixture()
def cantilever(tmp_path):
    """2D rect_tria 12x6 on [0,2]x[0,1], x=0 clamped, +x loads on x=2."""
    mesh = generate.rect_tria(0, 2, 12, 0, 1, 6)
    X = mesh.coords
    left = np.nonzero(X[:, 0] == 0.0)[0]
    right = np.nonzero(X[:, 0] == 2.0)[0]
    prefix = str(tmp_path / "beam")
    mesh_io.write_dat(
        prefix, mesh,
        dirichlet=np.array([[n, c, 0.0] for n in left for c in (0, 1)]),
        force=np.array([[n, 0, 1.0] for n in right]))
    return _files(prefix, force=True)


@pytest.mark.parametrize("case,extra", [
    ("poisson", []), ("poisson", ["--ksp", "gmres"]),
    ("elasticity", []), ("elasticity", ["--precond", "jacobi"])])
def test_sharded_cli_matches_jax(box, cantilever, tmp_path, capfd, case,
                                 extra):
    files = box if case == "poisson" else cantilever
    vj, vt = str(tmp_path / "j.vtk"), str(tmp_path / "t.vtk")
    argv = [case, *files, "--shards", "2", *extra]
    rc_j = j_main([*argv, "-o", vj])
    out_j = capfd.readouterr().out
    rc_t = t_main([*argv, "-o", vt, *CPU])
    out_t = capfd.readouterr().out
    assert rc_j == rc_t == 0
    assert _iters(out_t) == _iters(out_j)
    assert out_t.count("Convergence in") == 1 and out_t.count("Wrote") == 1
    assert np.abs(_solution(vt) - _solution(vj)).max() <= VTK_TOL
    assert _cells(vt) == _cells(vj)
    assert set(_procids(vt).tolist()) == {0, 1}


@pytest.fixture()
def jittered(tmp_path):
    """A box_tet 10x10x12 with its interior nodes moved by up to 0.1 of a
    cell and its nodes permuted: no lattice to recover, 891 free rows, so
    the sharded solve takes the ELL route and SA-AMG coarsens."""
    mesh, dbc = generate.box_tet(0, 1, 10, 0, 1, 10, 0, 1.2, 12)
    rng = np.random.default_rng(4)
    X = mesh.coords.copy()
    inside = ((X > 1e-9) & (X < X.max(axis=0) - 1e-9)).all(axis=1)
    X[inside] += rng.uniform(-0.01, 0.01, (int(inside.sum()), 3))
    perm = rng.permutation(mesh.n_node)
    mesh = type(mesh)(mesh.etype, X, mesh.conn).renumbered(
        perm.astype(np.int64))
    dbc = dbc.copy()
    dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    prefix = str(tmp_path / "jittered")
    mesh_io.write_dat(prefix, mesh, dirichlet=dbc)
    return _files(prefix)


@pytest.mark.parametrize("precond", ["mg", "amg"])
def test_sharded_cli_multigrid_preconditioners_match_jax(
        box, jittered, tmp_path, capfd, precond):
    """`--shards 2 --precond mg` on the box and `--precond amg` on the
    jittered mesh: the JAX CLI's printed iteration count, VTK solution and
    procid cells.  A mesh read from files carries no generator structure,
    so in both packages `--precond mg` takes the Jacobi fall-back of the
    distributed multigrid (timings["mg_refused"]) on the recovered DIA
    route; `--precond amg` runs the distributed SA-AMG on the ELL route."""
    files = box if precond == "mg" else jittered
    vj, vt = str(tmp_path / "j.vtk"), str(tmp_path / "t.vtk")
    argv = ["poisson", *files, "--shards", "2", "--precond", precond]
    rc_j = j_main([*argv, "-o", vj])
    out_j = capfd.readouterr().out
    rc_t = t_main([*argv, "-o", vt, *CPU])
    out_t = capfd.readouterr().out
    assert rc_j == rc_t == 0
    assert _iters(out_t) == _iters(out_j)
    assert out_t.count("Convergence in") == 1 and out_t.count("Wrote") == 1
    assert np.abs(_solution(vt) - _solution(vj)).max() <= VTK_TOL
    assert _cells(vt) == _cells(vj)
    assert set(_procids(vt).tolist()) == {0, 1}


def test_sharded_cli_cuda_needs_a_card_per_rank(box):
    found = torch.cuda.device_count()
    n = max(found + 1, 2)
    with pytest.raises(SystemExit, match=f"needs {n} CUDA cards.*"
                                         f"found {found}"):
        t_main(["poisson", *box, "--shards", str(n)])


def test_sharded_cli_fails_on_every_rank_without_a_dia_layout(tmp_path,
                                                              capfd):
    """The name is the refusal this case checked before the ELL route
    existed; it now checks that the mesh SOLVES.  A scrambled 3x3x4 box:
    no recovery (too few rows) and its DIA census is wider than a rank's
    rows, so both ranks take the ELL route.  Launched by hand in a process
    that never imports JAX, it exits 0 and prints and writes what the JAX
    CLI's `--shards 2` does on the same files: the same iteration count,
    the same VTK solution and procid cells."""
    mesh, dbc = generate.box_tet(0, 1, 3, 0, 1, 3, 0, 1, 4)
    perm = np.random.default_rng(0).permutation(mesh.n_node)
    mesh = mesh.renumbered(perm.astype(np.int64))
    dbc = dbc.copy()
    dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    prefix = str(tmp_path / "scrambled")
    mesh_io.write_dat(prefix, mesh, dirichlet=dbc)
    vj, vt = str(tmp_path / "j.vtk"), str(tmp_path / "t.vtk")
    argv = ["poisson", *_files(prefix), "--shards", "2"]
    code = ("import sys, runpy\n"
            f"sys.argv = ['pfemfort_tpu_torch', *{argv!r}, '-o', {vt!r},"
            " *" + repr(CPU) + "]\n"
            "try:\n"
            "    runpy.run_module('pfemfort_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    print('RC', e.code, 'jax' in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.stdout.strip().splitlines()[-1] == "RC 0 False", proc.stderr
    assert proc.stdout.count("Convergence in") == 1
    assert j_main([*argv, "-o", vj]) == 0
    out_j = capfd.readouterr().out
    assert _iters(proc.stdout) == _iters(out_j)
    assert np.abs(_solution(vt) - _solution(vj)).max() <= VTK_TOL
    assert _cells(vt) == _cells(vj)
    assert set(_procids(vt).tolist()) == {0, 1}
