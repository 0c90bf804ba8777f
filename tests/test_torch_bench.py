"""Port parity: the bench harness (pfemfort_tpu_torch/bench.py) and the
CLI's `bench` subcommand, on the CPU at toy sizes.

`python -m pfemfort_tpu_torch bench 8 0 0 --device cpu` runs in a fresh
process (which never imports JAX): every stage it ran is true in its last
line, and its counts equal the port's own solve_poisson / solve_implicit
at those sizes (flagship n=8; unstructured and amg at max(n, 16)).  Its
partition_quality edge cuts equal the JAX package's partition_elements and
native.edge_cut on the same Delaunay mesh.  A stage that raises or misses a
bar turns the exit code to 1 and the run goes on.  The port's bench
modules import neither JAX, nor the JAX package, nor the root bench.py.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pfemfort_tpu_torch import bench

REPO = Path(__file__).resolve().parents[1]
F32 = torch.float32
RAN = ["flagship", "partition_quality", "unstructured", "amg", "dist_spmv"]


def _poisson(c):
    from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices

    return poisson_element_matrices(c, "tetra4", source=-6.0)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("bench")
    proc = subprocess.run(
        [sys.executable, "-m", "pfemfort_tpu_torch", "bench", "8", "0", "0",
         "--device", "cpu", "--detail", str(d / "detail.json")], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    return dict(rc=proc.returncode, stderr=proc.stderr,
                last=json.loads(proc.stdout.splitlines()[-1]),
                lines=lines, dir=d,
                detail=json.loads((d / "detail.json").read_text()))


def test_cli_bench_runs_every_stage(run):
    assert run["rc"] == 0, run["stderr"][-3000:]
    last = run["last"]
    assert last["metric"] == "spmv_nnz_per_s" and last["unit"] == "nnz/s"
    assert last["value"] > 0 and last["device"] == "cpu"
    assert last["stages"] == dict.fromkeys(RAN, True)
    assert len(run["lines"]) == len(RAN) + 1      # one per stage, and last
    assert (run["dir"] / "BENCH_TORCH_PARTIAL.json").exists()
    for st in RAN:
        bars = run["detail"][st]["bars"]
        assert bars and all(b["ok"] for b in bars.values()), (st, bars)


def test_counts_equal_the_ports_own_solves(run):
    from pfemfort_tpu_torch import generate, solve_poisson
    from pfemfort_tpu_torch.drivers.common import solve_implicit

    det = run["detail"]
    mesh, dbc = generate.box_tet(0, 1, 8, 0, 1, 8, 0, 1, 8)
    r = solve_poisson(mesh, dbc, device="cpu", dtype=F32, rtol=1e-6)
    assert det["flagship"]["cg_iters"] == r.stats.iters
    r = solve_poisson(mesh, dbc, device="cpu", dtype=F32, rtol=1e-6,
                      maxiter=100, bc_mode="full", precond="mg")
    assert det["flagship"]["mg_cg_iters"] == r.stats.iters
    for stage, seed, pcs in (("unstructured", 0, {"jacobi": "cg_iters"}),
                             ("amg", 2, {"jacobi": "jacobi_iters",
                                         "amg": "amg_iters"})):
        pmesh, pdbc = bench._permuted_box(16, seed)
        for pc, key in pcs.items():
            r = solve_implicit(pmesh, 1, pdbc, _poisson, device="cpu",
                               dtype=F32, rtol=1e-6, recover=False,
                               precond=pc)
            assert det[stage][key] == r.stats.iters, (stage, pc)
    assert det["unstructured"]["cg_iters"] == \
        det["unstructured"]["lattice_cg_iters"]


def test_partition_cuts_equal_jax(run):
    from pfemfort_tpu import native
    from pfemfort_tpu.mesh.core import Mesh as JMesh
    from pfemfort_tpu.parallel.partition import partition_elements

    if not native.available():
        pytest.skip("the JAX package's native library is not built")
    mesh, rng = bench.delaunay_mesh()
    jmesh = JMesh("tetra4", mesh.coords, mesh.conn)
    det = run["detail"]["partition_quality"]
    assert det["n_elem"] == jmesh.n_elem == 93_980
    for method in ("rcb", "greedy"):
        part = partition_elements(jmesh, 8, method=method)
        assert det[f"{method}_edge_cut"] == native.edge_cut(
            jmesh.conn, jmesh.n_node, 3, part)
    rand = rng.permutation(np.arange(jmesh.n_elem) % 8).astype(np.int32)
    assert det["random_edge_cut"] == native.edge_cut(jmesh.conn,
                                                     jmesh.n_node, 3, rand)


def _raise(*_):
    raise RuntimeError("made to fail")


def test_a_failed_stage_exits_nonzero(tmp_path, monkeypatch, capsys):
    """partition_quality made to raise and amg made to miss its nodal bar:
    both record an error, the other stages run, the exit code is 1."""
    monkeypatch.setattr(bench, "partition_quality", _raise)
    monkeypatch.setitem(bench.NODAL, "amg", 0.0)
    rc = bench.main(["8", "0", "0", "--device", "cpu", "--detail",
                     str(tmp_path / "d.json")])
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 1
    assert last["stages"] == dict(dict.fromkeys(RAN, True),
                                  partition_quality=False, amg=False)
    det = json.loads((tmp_path / "d.json").read_text())
    assert "made to fail" in det["partition_quality"]["error"]
    assert "jacobi_converged" in det["amg"]["error"]


def test_without_a_card_the_default_device_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="cuda"):
        bench.main(["8", "0", "0", "--detail", str(tmp_path / "d.json")])


@pytest.mark.parametrize("module", [
    "pfemfort_tpu_torch/bench.py", "pfemfort_tpu_torch/bench_scaling.py",
    "pfemfort_tpu_torch/host_native.py", "pfemfort_tpu_torch/utils/timing.py",
    "chip_smoke.py"])
def test_no_jax_and_no_root_bench(module):
    src = (REPO / module).read_text()
    imports = re.findall(r"^\s*(?:import|from)\s+([\w.]+)", src, re.M)
    bad = [m for m in imports if m.split(".")[0] in ("jax", "jaxlib")
           or m == "pfemfort_tpu" or m.startswith("pfemfort_tpu.")
           or m in ("bench", "bench_scaling")]
    assert not bad, bad
