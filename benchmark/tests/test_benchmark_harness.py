"""The benchmark harness on the CPU: registry, yardstick arithmetic, the plain
reference against known solutions, and every cell's plumbing at a tiny
size.  Run: python -m pytest benchmark/tests -q"""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402
from benchmark.harness import check, peaks, registry, trace  # noqa: E402
from benchmark.harness.traffic import Traffic  # noqa: E402
from benchmark.reference import fem  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
# The 48M float32 Jacobi cell is not in BENCHMARK.json (its analysis time
# swings with the host: PERF.md §7), but its configuration, mix and limits
# stay for the cell's return, and the tests below still drive them.
JACOBI48 = "poisson48m.cg_f32"
BENCH["workloads"].append(dict(name=JACOBI48, config="poisson3d_box48m",
                               traffic="cg_f32", chips=1))
box_tet = registry.module("meshes", "box_tet")


def tiny_mesh(name, n=4):
    """The cell's mesh spec cut to n cells a side (the box's extent kept)."""
    mesh = registry.Cell(BENCH, name, ROOT).config["mesh"]
    return {"mesh": dict(mesh, cells=[n, n, n])}


def tiny_traffic(name, n=4, seed=7, **mix):
    cell = registry.Cell(BENCH, name, ROOT)
    cfg = dict(cell.config, **tiny_mesh(name, n))
    return cell, Traffic(cfg, dict(cell.mix, **mix), seed, "cpu")


# ---- registry ---------------------------------------------------------------
@pytest.mark.parametrize("name", CELLS)
def test_registry_finds_each_piece_by_name(name):
    cell = registry.Cell(BENCH, name, ROOT)
    entry = registry.module("entries", cell.mix["entry"])
    number = registry.module("numbers", entry.NUMBER)
    assert callable(entry.run) and isinstance(entry.RESUMES, bool)
    assert callable(number.value) and callable(number.control)
    assert entry.NUMBER in cell.limits
    physics = registry.module("physics", cell.config["physics"])
    assert physics.NDOF in (1, 3)
    registry.module("meshes", cell.config["mesh"]["kind"])
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    for m in cell.end_to_end:
        mod = registry.module("metrics", m["name"])
        assert (mod.UNIT, mod.SOURCE) == (m["unit"], m["source"])
    assert cell.per_layer
    for m in cell.per_layer:
        mod = registry.module("metrics", m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE) == \
            (m["unit"], m["layer"], m["moves"], m["source"])
        assert m["moves"] in reported


def test_registry_refuses_an_unknown_name():
    with pytest.raises(KeyError):
        registry.module("entries", "no_such_entry")
    with pytest.raises(ValueError):
        registry.module("mixes", "cg_f32")


def test_the_harness_names_no_entry_mesh_or_physics():
    """What a cell is made of is found by name: the general code holds no
    entry, number, mesh kind or physics of its own."""
    names = set()
    for kind in ("entries", "numbers", "meshes", "physics"):
        names |= {p.stem for p in (ROOT / "benchmark" / kind).glob("*.py")}
    general = sorted((ROOT / "benchmark" / "harness").glob("*.py")) + \
        [ROOT / "benchmark" / "run.py", ROOT / "benchmark" / "calibrate.py"]
    for path in general:
        text = path.read_text()
        for n in names:
            assert f'"{n}"' not in text and f"'{n}'" not in text, (path, n)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_counts_match_its_mesh(cfg):
    c = json.loads((ROOT / cfg["file"]).read_text())
    mesh = registry.module("meshes", c["mesh"]["kind"])
    n = mesh.counts(c["mesh"], c["dirichlet"]["faces"])
    assert (c["elements"], c["nodes"]) == (n["elements"], n["nodes"])
    ndof = registry.module("physics", c["physics"]).NDOF
    assert c["free_dofs"] == (c["nodes"] - n["dirichlet_nodes"]) * ndof
    small = box_tet.build(dict(c["mesh"], cells=[5, 4, 3]))
    nb = len(box_tet.boundary_nodes(small, c["dirichlet"]["faces"]))
    assert nb == box_tet.counts(dict(c["mesh"], cells=[5, 4, 3]),
                                c["dirichlet"]["faces"])["dirichlet_nodes"]


def test_box_tet_is_the_generators():
    from pfemfort_tpu_torch.mesh import generate
    m = box_tet.build(dict(kind="box_tet", cells=[3, 2, 4],
                           box=[[0, 1], [0, 2], [1, 3]]))
    port, _ = generate.box_tet(0, 1, 3, 0, 2, 2, 1, 3, 4)
    np.testing.assert_array_equal(m.conn, port.conn)
    np.testing.assert_allclose(m.coords, port.coords, rtol=0, atol=0)
    assert m.structure == port.structure


def test_warm_up_runs_the_cell_on_its_small_mesh():
    _, tr = tiny_traffic("elast64.explicit", n=12)
    w = tr.warm()
    assert w.mesh_arrays.structure["nex"] == box_tet.WARM_CELLS
    assert w.entry is tr.entry and w.physics is tr.physics
    np.testing.assert_allclose(w.mesh_arrays.coords.max(0),
                               tr.mesh_arrays.coords.max(0))


# ---- the yardstick's arithmetic ---------------------------------------------
def test_b1_byte_count_is_kept_once_per_configuration(tmp_path,
                                                      monkeypatch):
    b1 = registry.module("metrics", "b1_roofline")
    monkeypatch.setattr(b1, "CACHE", tmp_path)
    _, tr = tiny_traffic(JACOBI48, n=3)
    load = tr.next_load()
    p = check.reference_problem(tr)
    n, nnz, n_off = fem.reduced_nonzeros(
        p, tr.physics.dirichlet_dofs(tr, load, p)[0])
    want = peaks.dia_spmv_bytes(nnz, n, n_off, 4)
    assert b1.b1_bytes(tr, load) == want
    assert len(list(tmp_path.iterdir())) == 1
    monkeypatch.setattr(fem, "reduced_nonzeros", None)   # read, not counted
    assert b1.b1_bytes(tr, load) == want


def test_b1_byte_count_is_the_ports():
    from pfemfort_tpu_torch.sparse.dia import DIAMatrix
    from pfemfort_tpu_torch.utils.timing import spmv_work
    A = DIAMatrix(vals=torch.zeros(3, 10), offsets=(-1, 0, 1), n_rows=10)
    assert peaks.dia_spmv_bytes(28, 10, 3, 4) == spmv_work(A, 28)[0]


def _dense_reduced(p, bc):
    n = p.n_full
    K = np.zeros((n, n))
    Ke = fem._element_matrices(p, slice(0, None)).numpy()
    dofs = fem._dofs(p, slice(0, None)).numpy()
    for e in range(dofs.shape[0]):
        K[np.ix_(dofs[e], dofs[e])] += Ke[e]
    free = np.setdiff1d(np.arange(n), bc.numpy())
    return K[np.ix_(free, free)]


@pytest.mark.parametrize("name", [JACOBI48, "elast64.cg_f32"])
def test_reduced_nonzeros_count_the_dense_system(name):
    _, tr = tiny_traffic(name, n=3)
    p = check.reference_problem(tr)
    bc, _ = tr.physics.dirichlet_dofs(tr, tr.next_load(), p)
    K = _dense_reduced(p, bc)
    nz = np.abs(K) > 1e-12 * np.abs(K).max()
    i, j = np.nonzero(nz)
    assert fem.reduced_nonzeros(p, bc) == (K.shape[0], int(nz.sum()),
                                           len(np.unique(j - i)))


def test_union_and_gaps():
    assert trace.union([(5, 8), (0, 2), (1, 3), (8, 9)]) == [(0, 3), (5, 9)]
    assert trace.gaps_of([(0, 3), (5, 9)], 0, 12) == [(3, 5), (9, 12)]
    assert trace.gaps_of([(2, 20)], 0, 12) == [(0, 2)]


class FakeEvent:
    def __init__(self, name, dev, start, dur, annotation=False):
        self._n, self._d, self._s, self._t, self._a = name, dev, start, dur, \
            annotation

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t

    def is_user_annotation(self):
        return self._a


def test_idle_share_on_synthetic_intervals():
    CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ev = [FakeEvent(trace.UNIT_SPAN, CPU, 0, 100),
          FakeEvent(trace.UNIT_SPAN, CUDA, 0, 100, annotation=True),
          FakeEvent("dia_spmv_kernel<float>", CUDA, 10, 10),
          FakeEvent("dia_spmv_kernel<float>", CUDA, 15, 15),
          FakeEvent("segment_reduce", CUDA, 50, 10),
          FakeEvent("aten::mm", CPU, 60, 40),
          FakeEvent("aten::to", CPU, 0, 4),
          FakeEvent("late", CUDA, 95, 20)]
    t = trace.reduce_events(ev)
    assert t.window_s == pytest.approx(100e-9)
    assert t.busy_s == pytest.approx(35e-9)        # [10,30) [50,60) [95,100)
    assert t.idle_share() == pytest.approx(0.65)
    assert t.device_seconds("dia_spmv") == (pytest.approx(25e-9), 2)
    assert t.gaps[0] == ("aten::mm", pytest.approx(35e-9))
    assert t.gaps[1] == (trace.HOST_ONLY, pytest.approx(20e-9))
    assert t.gaps[2] == (trace.HOST_ONLY + "; aten::to 40%",
                         pytest.approx(10e-9))
    assert [n for n, _ in t.breakdown()["device_ops"]][0] == \
        "dia_spmv_kernel<float>"


# ---- the plain reference against known solutions ----------------------------
def test_reference_poisson_manufactured_solution():
    _, tr = tiny_traffic(JACOBI48, n=5, dtype="float64")
    p = check.reference_problem(tr)
    load = dict(a=1.3, b=-0.4, c=0.7)
    bc, g = tr.physics.dirichlet_dofs(tr, load, p)
    F = tr.physics.load_vector(tr, load, p)
    exact = torch.as_tensor(tr.physics.exact(load, tr.mesh_arrays.coords))
    n = fem.residual_norms(p, F, exact, bc, g)
    assert n["r_free"] / n["b_reduced"] < 1e-13 and n["bc_misfit"] == 0
    u, _ = fem.cg(p, F, bc, g, 1e-12, 500)
    assert float((u - exact).abs().max()) < 1e-10


def test_reference_elasticity_patch_and_element_matrices():
    _, tr = tiny_traffic("elast64.cg_f32", n=3)
    p = check.reference_problem(tr)
    x = torch.as_tensor(tr.mesh_arrays.coords)
    A = torch.tensor([[0.1, -0.2, 0.3], [0.05, 0.2, -0.1], [0.0, 0.4, 0.1]],
                     dtype=torch.float64)
    u = (x @ A.T + torch.tensor([0.3, 0.1, -0.2],
                                dtype=torch.float64)).reshape(-1)
    f = fem.apply(p, u).reshape(-1, 3)
    interior = torch.ones(p.n_node, dtype=torch.bool)
    interior[torch.as_tensor(box_tet.boundary_nodes(tr.mesh_arrays, "all"))] \
        = False
    assert float(f[interior].abs().max()) < 1e-12 * float(f.abs().max())
    v = torch.randn(p.n_full, dtype=torch.float64)
    Ke = fem._element_matrices(p, slice(0, None))
    dofs = fem._dofs(p, slice(0, None))
    y = torch.zeros_like(v).index_add_(
        0, dofs.reshape(-1), torch.einsum("bij,bj->bi", Ke, v[dofs])
        .reshape(-1))
    torch.testing.assert_close(y, fem.apply(p, v), rtol=1e-12, atol=1e-12)
    d = torch.diagonal(Ke, dim1=1, dim2=2)
    torch.testing.assert_close(
        torch.zeros_like(v).index_add_(0, dofs.reshape(-1), d.reshape(-1)),
        fem.diagonal(p), rtol=1e-12, atol=1e-14)


def test_reference_explicit_loop_is_the_ports_in_float64():
    _, tr = tiny_traffic("elast64.explicit", n=3, dtype="float64",
                         block_steps=200)
    units = [tr.run_unit(), tr.run_unit()]
    assert registry.module("numbers", "state_gap").value(tr, units) < 1e-9


# ---- every cell's plumbing at a tiny size -----------------------------------
def tiny_mix(name):
    mix = dict(dtype="float64")
    if "block_steps" in registry.Cell(BENCH, name, ROOT).mix:
        mix.update(block_steps=100, warm_steps=5)
    return mix


@pytest.mark.parametrize("name", CELLS)
def test_tiny_cell_runs_on_the_cpu(name):
    out = run.run_cell(BENCH, name, 2 ** 31 + 11, 0.2, trace=False,
                       device="cpu", config_patch=tiny_mesh(name),
                       mix_patch=tiny_mix(name))
    assert out["correct"] and out["attempted"] >= 1 and out["failed"] == 0
    cell = registry.Cell(BENCH, name, ROOT)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(out)[-1] == "checks"
    assert out["checks"]["unconverged"] == dict(value=0, limit=0)


def test_tiny_traced_run_reads_its_per_layer_metrics():
    out = run.run_cell(BENCH, "elast64.cg_f32", 5, 0.1, trace=True,
                       device="cpu", config_patch=tiny_mesh("elast64.cg_f32"),
                       mix_patch=dict(dtype="float64"))
    assert out["correct"]
    assert {"host_setup_s", "assembly_s", "krylov_ms_per_iter", "cg_iters",
            "device_idle_pct.analysis"} <= set(out["metrics"])
    assert "b1_roofline" not in out["metrics"]   # no B1 launch on the CPU
    assert out["device"]["window_s"] > 0 and "breakdown" in out


def test_same_seed_same_loads():
    _, a = tiny_traffic(JACOBI48, seed=2 ** 31 + 5)
    _, b = tiny_traffic(JACOBI48, seed=2 ** 31 + 5)
    assert [a.next_load() for _ in range(3)] == \
        [b.next_load() for _ in range(3)]


# ---- what a run may load, and where it may run ----------------------------
def test_import_check_compares_whole_top_level_names(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pfemfort_tpu_torch_extra",
                        types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pfemfort_tpu.sparse",
                        types.ModuleType("y"))
    assert run.forbidden_modules() == ["pfemfort_tpu"]


def test_a_tiny_run_loads_no_jax():
    code = ("import sys, json; sys.path.insert(0, %r); from benchmark import "
            "run; b = json.load(open(%r)); run.run_cell(b, "
            "'elast64.cg_f32', 3, 0.05, False, device='cpu', "
            "config_patch=%r, mix_patch={'dtype': 'float64'}); "
            "print(run.forbidden_modules())"
            % (str(ROOT), str(ROOT / "BENCHMARK.json"),
               tiny_mesh("elast64.cg_f32")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_run_fails_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode != 0 and out.stdout == ""


# ---- on the card -----------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_tiny_cell_runs_on_the_card(card, name):
    mix = tiny_mix(name)
    del mix["dtype"]
    out = run.run_cell(BENCH, name, 17, 0.2, trace=True, device=card,
                       config_patch=tiny_mesh(name, 8), mix_patch=mix)
    assert out["device"]["busy_s"] > 0 and out["attempted"] >= 1
