"""The per-layer metrics that read the program's own spans and counters, on
tiny CPU runs of their cells; and each reader on a program that has no
such span (it returns None and does not raise).
Run: python -m pytest benchmark/tests -q"""

import json
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402
from benchmark.harness import registry  # noqa: E402
from pfemfort_tpu_torch.utils import timing  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = {
    "elast64.cg_f32": ["host_setup.census_s", "host_setup.dofmap_s",
                       "host_setup.plan_s", "host_setup.coords_s",
                       "krylov_host_ms_per_iter", "host_reads_per_iter"],
    "poisson48m.mg_f64": ["assembly.affine_s", "mg_setup.coarsen_s",
                          "krylov_host_ms_per_iter", "host_reads_per_iter"],
    "elast64.explicit": ["explicit_setup_s", "loop_ms_per_step"],
}
EXPLICIT_MIX = dict(dtype="float64", block_steps=60, warm_steps=5)


def tiny(name, n):
    mesh = registry.Cell(BENCH, name, ROOT).config["mesh"]
    return {"mesh": dict(mesh, cells=[n, n, n])}


def test_every_span_metric_is_listed_in_its_cells():
    listed = {m["name"]: m["workloads"] for m in BENCH["per_layer"]}
    for cell, names in SPAN_METRICS.items():
        for name in names:
            assert cell in listed[name], (cell, name)


@pytest.mark.parametrize("name,n", [("elast64.cg_f32", 4),
                                    ("poisson48m.mg_f64", 8)])
def test_implicit_span_metrics_read_a_tiny_traced_run(name, n):
    out = run.run_cell(BENCH, name, 2 ** 31 + 19, 0.1, trace=True,
                       device="cpu", config_patch=tiny(name, n),
                       mix_patch=dict(dtype="float64"))
    assert out["correct"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(SPAN_METRICS[name]) <= set(m)
    assert all(m[k] >= 0 for k in SPAN_METRICS[name])
    # one read a loop test and the final statistics, a little over one an
    # iteration at any size
    assert m["host_reads_per_iter"] > 1
    if name == "elast64.cg_f32":
        kids = sum(m[k] for k in SPAN_METRICS[name][:4])
        assert kids <= m["host_setup_s"]
    else:
        assert m["assembly.affine_s"] <= m["assembly_s"]
        assert m["mg_setup.coarsen_s"] <= m["mg_setup_s"]


def test_explicit_span_metrics_read_the_window_alone():
    name = "elast64.explicit"
    timing.RECENT.clear()
    out = run.run_cell(BENCH, name, 2 ** 31 + 23, 0.3, trace=True,
                       device="cpu", config_patch=tiny(name, 4),
                       mix_patch=EXPLICIT_MIX)
    assert out["correct"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(SPAN_METRICS[name]) <= set(m)
    recs = list(timing.RECENT)
    # the warm-up first, the traced block last: neither is read
    assert recs[0].timings["steps"] == EXPLICIT_MIX["warm_steps"]
    assert recs[-1].profiled and not any(r.profiled for r in recs[:-1])
    window = recs[1:-1]
    assert len(window) == out["window"]["units"]
    mean_setup = sum(r.timings["explicit.setup_s"] for r in window) \
        / len(window)
    assert m["explicit_setup_s"] == pytest.approx(mean_setup)
    loop = sum(r.timings["explicit.loop_s"] for r in window)
    assert m["loop_ms_per_step"] == pytest.approx(
        1e3 * loop / (len(window) * EXPLICIT_MIX["block_steps"]))
    # the set-up and the loop hold most of each block
    for r, unit_s in zip(window, out["window"]["unit_s"]):
        inside = r.timings["explicit.setup_s"] + r.timings["explicit.loop_s"]
        assert inside <= unit_s


def test_readers_find_nothing_in_a_program_without_spans(monkeypatch):
    """The parent commit's program: stage timings only, no RECENT."""
    units = [dict(timings=dict(pattern_s=1.0, assemble_s=0.5, solve_s=0.2),
                  iters=10, steps=60)]
    rec = types.SimpleNamespace(
        units=units, timed=units, trace=None,
        traffic=types.SimpleNamespace(mix=dict(block_steps=60)))
    monkeypatch.delattr(timing, "RECENT")
    for names in SPAN_METRICS.values():
        for name in names:
            assert registry.module("metrics", name).read(rec) is None, name
