"""The cell quadhg8m.explicit on the CPU: its files, its mesh kind and
plain reference, its metric's byte count, and its check, which passes a
sound tiny run and fails what it must:

  control      the plain reference's own time loop in bfloat16, the
               precision below the cell's float32;
  faults       the program with its hourglass term dropped (the residual's
               hg_visc at 0), and the program with its point loads left off.

The program in float64, the reference's precision, meets it by far.

The tiny rectangle keeps the configuration's material, dt and cell size h,
with a handful of isolated point loads, so the hourglass term carries
weight as the configuration's 64 loads do on its free end.  Run:
python -m pytest benchmark/tests -q"""

import functools
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import pfemfort_tpu_torch  # noqa: E402
from pfemfort_tpu_torch.dynamics import explicit as explicit_mod  # noqa: E402
from pfemfort_tpu_torch.utils import timing  # noqa: E402

from benchmark import run  # noqa: E402
from benchmark.harness import check, registry  # noqa: E402
from benchmark.harness.traffic import Traffic  # noqa: E402
from benchmark.reference import quad_hg  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = "quadhg8m.explicit"
CELL = registry.Cell(BENCH, NAME, ROOT)
rect_quad = registry.module("meshes", "rect_quad")
H = 0.006                                  # the configuration's cell size
TINY = (48, 24)
TINY_MIX = dict(block_steps=1000, warm_steps=5)
SEED = 2 ** 31 + 9


def tiny_config(cells=TINY, points=4):
    nx, ny = cells
    return dict(mesh=dict(CELL.config["mesh"], cells=[nx, ny],
                          box=[[0.0, nx * H], [0.0, ny * H]]),
                load=dict(CELL.config["load"], points=points))


def tiny_run(seconds=0.01, **mix):
    return run.run_cell(BENCH, NAME, SEED, seconds, trace=False,
                        device="cpu", config_patch=tiny_config(),
                        mix_patch=dict(TINY_MIX, **mix))


def test_the_cells_files_load_and_its_metrics_are_listed():
    entry = registry.module("entries", CELL.mix["entry"])
    number = registry.module("numbers", entry.NUMBER)
    assert entry.NUMBER == "quad_state_gap" and entry.RESUMES
    assert callable(number.value) and callable(number.control)
    assert set(CELL.limits) == {"quad_state_gap"}
    physics = registry.module("physics", CELL.config["physics"])
    assert physics.NDOF == 2
    assert CELL.workload["chips"] == 1
    assert {m["name"] for m in CELL.end_to_end} == {"step_ms", "peak_gib",
                                                    "setup_s"}
    assert {m["name"] for m in CELL.per_layer} == {
        "explicit_setup_s", "loop_ms_per_step", "device_idle_pct.explicit",
        "quadhg_step_roofline"}
    for m in CELL.per_layer:
        mod = registry.module("metrics", m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE) == \
            (m["unit"], m["layer"], m["moves"], m["source"])


def test_the_configuration_counts_match_its_mesh():
    c = CELL.config
    n = rect_quad.counts(c["mesh"], c["dirichlet"]["faces"])
    assert (c["elements"], c["nodes"]) == (n["elements"], n["nodes"])
    assert c["free_dofs"] == (c["nodes"] - n["dirichlet_nodes"]) * 2
    small = rect_quad.build(dict(c["mesh"], cells=[5, 3]))
    for faces in ("x0", "x1"):
        nodes = rect_quad.boundary_nodes(small, faces)
        assert len(nodes) == rect_quad.counts(
            dict(c["mesh"], cells=[5, 3]), faces)["dirichlet_nodes"]
        x = small.coords[nodes, 0]
        assert np.all(x == (0.0 if faces == "x0" else c["mesh"]["box"][0][1]))
    assert len(c["load"]["draw"]) == c["load"]["points"] == 64
    (x0, x1), (y0, y1) = c["mesh"]["box"]
    assert (x1 - x0) / c["mesh"]["cells"][0] == pytest.approx(H)
    assert (y1 - y0) / c["mesh"]["cells"][1] == pytest.approx(H)


def test_rect_quad_is_the_generators():
    from pfemfort_tpu_torch.mesh import generate
    m = rect_quad.build(dict(kind="rect_quad", cells=[3, 2],
                             box=[[0, 1], [1, 3]]))
    port = generate.rect_quad(0, 1, 3, 1, 3, 2)
    np.testing.assert_array_equal(m.conn, port.conn)
    np.testing.assert_allclose(m.coords, port.coords, rtol=0, atol=0)
    assert m.etype == port.etype and m.structure is None
    with pytest.raises(ValueError):
        rect_quad.build(dict(kind="rect_quad", cells=[3, 2, 2],
                             box=[[0, 1], [1, 3]]))


def test_dt_sits_at_a_quarter_of_the_critical_step():
    """The configuration's dt against the stability limit of its cell size,
    by power iteration on the plain reference over a patch of cells of that
    size (the limit is local: it is the patch's at any size above a few
    cells)."""
    cfg = dict(CELL.config, **tiny_config((32, 16)))
    tr = Traffic(cfg, CELL.mix, SEED, "cpu")
    p = check.reference_problem(tr)
    bc, _ = tr.physics.dirichlet_dofs(tr, None, p)
    dt_crit = quad_hg.critical_step(p, bc, iters=1500)
    assert dt_crit == pytest.approx(3.795e-5, rel=2e-3)
    assert 0.2 <= CELL.config["explicit"]["dt"] / dt_crit <= 1 / 3


def test_the_point_loads_are_the_configurations():
    tr = Traffic(dict(CELL.config, **tiny_config((64, 32), points=64)),
                 CELL.mix, SEED, "cpu")
    load = tr.next_load()
    rows = tr.physics.force_rows(tr, load)
    assert rows.shape == (33, 3)      # the whole free end, 33 nodes
    nodes = rows[:, 0].astype(np.int64)
    assert np.all(tr.mesh_arrays.coords[nodes, 0] == 64 * H)
    assert len(set(nodes)) == 33 and np.all(rows[:, 1] == 1)
    assert np.all((rows[:, 2] >= 500.0) & (rows[:, 2] <= 2000.0))
    tr4 = Traffic(dict(CELL.config, **tiny_config((64, 32), points=4)),
                  CELL.mix, SEED, "cpu")
    rows4 = tr4.physics.force_rows(tr4, load)
    assert np.diff(rows4[:, 0]).min() >= 8 * 65    # isolated along the end
    p = check.reference_problem(tr4)
    F = tr4.physics.load_vector(tr4, load, p)
    assert float(F.sum()) == pytest.approx(rows4[:, 2].sum())


def test_a_tiny_run_is_correct():
    """The cell's float32, whose velocity-form update keeps the velocities
    within a few 1e-4 of the float64 reference on the tiny plate."""
    assert CELL.mix["dtype"] == "float32"
    out = tiny_run()
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert out["checks"]["quad_state_gap"]["value"] < 1e-3
    assert set(out["metrics"]) == {"step_ms", "peak_gib", "setup_s"}


def test_the_program_in_float64_is_correct_to_round_off():
    out = tiny_run(dtype="float64")
    assert out["correct"], out["checks"]
    assert out["checks"]["quad_state_gap"]["value"] < 1e-9


def test_the_control_is_not_correct():
    tr = Traffic(dict(CELL.config, **tiny_config()),
                 dict(CELL.mix, **TINY_MIX), SEED, "cpu")
    number = registry.module("numbers", "quad_state_gap")
    assert number.CONTROL.startswith("bfloat16")
    units = number.control(tr, 2)
    verdict = check.judge(tr, units, CELL.limits)
    assert not verdict["correct"], verdict


def test_a_run_without_the_hourglass_term_is_not_correct(monkeypatch):
    monkeypatch.setattr(explicit_mod, "quad_hg_residual", functools.partial(
        explicit_mod.quad_hg_residual, hg_visc=0.0))
    out = tiny_run()
    assert not out["correct"], out["checks"]
    assert out["failed"] == 0      # failed by the number alone
    assert out["checks"]["quad_state_gap"]["value"] > \
        CELL.limits["quad_state_gap"]


def test_a_run_without_the_point_loads_is_not_correct(monkeypatch):
    orig = pfemfort_tpu_torch.explicit_dynamics

    def unloaded(*args, **kwargs):
        kwargs["force_bc"] = None
        return orig(*args, **kwargs)
    monkeypatch.setattr(pfemfort_tpu_torch, "explicit_dynamics", unloaded)
    out = tiny_run()
    assert not out["correct"], out["checks"]
    assert out["checks"]["quad_state_gap"]["value"] == 1.0


def _state_unchanged(res, kwargs):
    s = kwargs.get("init_state")
    z = np.zeros_like(res.disp)
    return res._replace(disp=z if s is None else s.disp,
                        disp_prev=z if s is None else s.disp_prev,
                        velo=z if s is None else s.velo)


def _answer_altered(res, kwargs):
    d = res.disp.copy()
    k = int(np.argmax(np.abs(d)))
    d[k] += np.abs(d).max()
    return res._replace(disp=d)


def _unconverged(res, kwargs):
    d = res.disp.copy()
    d[-1] = np.nan
    return res._replace(disp=d)


@pytest.mark.parametrize("fault", [_state_unchanged, _answer_altered,
                                   _unconverged],
                         ids=["state_unchanged", "answer_altered",
                              "unconverged"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    """The three faults test_benchmark_control.py plants in every cell it
    sizes, here for this one: a block that returns the state it was given,
    an answer altered where it is produced, a state that is not finite."""
    orig = pfemfort_tpu_torch.explicit_dynamics
    monkeypatch.setattr(pfemfort_tpu_torch, "explicit_dynamics",
                        lambda *a, **k: fault(orig(*a, **k), k))
    out = tiny_run()
    assert not out["correct"], out["checks"]


def test_the_gap_of_a_state_that_is_not_finite_is_inf():
    tr = Traffic(dict(CELL.config, **tiny_config()),
                 dict(CELL.mix, block_steps=20), SEED, "cpu")
    unit = tr.run_unit()
    unit["answer"]["velo"][3] = np.nan
    assert registry.module("numbers", "quad_state_gap").value(tr, [unit]) \
        == float("inf")


def test_the_roofline_counts_the_steps_least_bytes():
    """conn, coords, disp, w and velo, the mass a node, 64 ForceBC rows
    and the free mask read; disp, w and velo written."""
    traffic = SimpleNamespace(mesh_arrays=rect_quad.build(
        CELL.config["mesh"]), dtype=torch.float32, config=CELL.config)
    roof = registry.module("metrics", "quadhg_step_roofline")
    E, n_node = 4096 * 2048, 4097 * 2049
    n_full = 2 * n_node
    want = 4 * 4 * E + 2 * n_node * 4 + 3 * n_full * 4 + n_node * 4 \
        + 64 * 8 + n_full + 3 * n_full * 4
    assert roof.step_bytes(traffic) == want == 654_692_926
    # bound by memory: the operations take under a tenth of the bytes'
    # time at the data sheet's float32 rate
    assert roof.step_flops(traffic) / 67e12 < 0.1 * want / 3.35e12


def test_the_roofline_reads_the_traced_blocks_counter(monkeypatch):
    """B3's two passes' device time a step of the traced block's
    explicit.hg_kernel_steps; None without a trace or without the counter
    (the parent's program)."""
    roof = registry.module("metrics", "quadhg_step_roofline")
    traffic = SimpleNamespace(mesh_arrays=rect_quad.build(
        dict(kind="rect_quad", cells=[8, 4], box=[[0, 1], [0, 1]])),
        dtype=torch.float32, config=CELL.config)
    ops = {"(anonymous namespace)::element_pass_hourglass(int const*)": 0.3,
           "(anonymous namespace)::node_pass(int const*)": 0.5,
           "Memcpy HtoD": 0.1}
    trace = SimpleNamespace(device_seconds=lambda pat: (
        sum(v for k, v in ops.items() if pat in k),
        sum(1 for k in ops if pat in k)))
    rec = SimpleNamespace(traffic=traffic, trace=trace, units=[])
    monkeypatch.setattr(timing, "RECENT", [
        timing.Record("explicit_dynamics", {"steps": 5000}, False),
        timing.Record("explicit_dynamics",
                      {"steps": 1000, "explicit.hg_kernel_steps": 1000},
                      True)])
    least = roof.step_bytes(traffic) / 3.35e12
    assert roof.read(rec) == pytest.approx(100 * least / (0.8 / 1000))
    monkeypatch.setattr(timing, "RECENT", [
        timing.Record("explicit_dynamics", {"steps": 1000}, True)])
    assert roof.read(rec) is None
    monkeypatch.delattr(timing, "RECENT")
    assert roof.read(rec) is None
    assert roof.read(SimpleNamespace(traffic=traffic, trace=None)) is None


def test_the_metrics_read_a_tiny_traced_run():
    timing.RECENT.clear()
    out = run.run_cell(BENCH, NAME, SEED, 0.05, trace=True, device="cpu",
                       config_patch=tiny_config(),
                       mix_patch=dict(TINY_MIX, block_steps=100))
    assert out["correct"]
    m = out["metrics"]
    assert {"explicit_setup_s", "loop_ms_per_step",
            "device_idle_pct.explicit"} <= set(m)
    assert "quadhg_step_roofline" not in m      # no B3 on the CPU
