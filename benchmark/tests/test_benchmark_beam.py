"""The cell beam4m5.ic0_f64 on the CPU at a tiny size: its files load, its
new metrics read the program's IC(0) spans and are listed in it, its check
fails what it must, and a program that does not run the cell's
preconditioner is refused at the warm-up.  (test_benchmark_control.py and
test_benchmark_spans.py hold the cells before it.)
Run: python -m pytest benchmark/tests -q"""

import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import pfemfort_tpu_torch  # noqa: E402

from benchmark import run  # noqa: E402
from benchmark.harness import check, registry  # noqa: E402
from benchmark.harness.traffic import Traffic  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = "beam4m5.ic0_f64"
IC0_METRICS = ["ic0_setup_s", "ic0_setup.csr_s", "ic0_setup.factor_s",
               "ic0_setup.layout_s"]
# the accepted metrics the cell is appended to
SHARED = ["host_setup_s", "cg_iters", "krylov_ms_per_iter",
          "krylov_host_ms_per_iter", "device_idle_pct.analysis",
          "host_setup.census_s", "host_setup.dofmap_s", "host_setup.plan_s",
          "host_setup.coords_s", "assembly_s", "host_reads_per_iter"]
CELLS = (6, 2, 2)      # a tiny beam, the configuration's extent kept


def tiny():
    mesh = registry.Cell(BENCH, NAME, ROOT).config["mesh"]
    return {"mesh": dict(mesh, cells=list(CELLS))}


def test_the_cells_files_load_and_its_metrics_are_listed():
    cell = registry.Cell(BENCH, NAME, ROOT)
    assert cell.workload["chips"] == 1
    assert cell.mix["options"] == {"precond": "ic0"}
    assert cell.mix["dtype"] == "float64" and cell.mix["rtol"] == 1e-8
    assert set(cell.limits) == {"relres"}
    assert {m["name"] for m in cell.end_to_end} == {"analysis_s",
                                                    "peak_gib", "setup_s"}
    listed = {m["name"]: m.get("workloads") for m in BENCH["per_layer"]}
    for name in IC0_METRICS:
        assert listed[name] == [NAME]
    for name in SHARED:
        assert NAME in listed[name], name
    assert NAME not in listed["b1_roofline"]
    for name in IC0_METRICS:
        mod = registry.module("metrics", name)
        assert mod.LAYER == "preconditioner set-up"


def test_the_ic0_metrics_read_a_tiny_traced_run():
    out = run.run_cell(BENCH, NAME, 2 ** 31 + 29, 0.1, trace=True,
                       device="cpu", config_patch=tiny())
    assert out["correct"] and out["failed"] == 0
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(IC0_METRICS) | set(SHARED) <= set(m)
    assert all(m[k] > 0 for k in IC0_METRICS)
    assert sum(m[k] for k in IC0_METRICS[1:]) <= m["ic0_setup_s"]
    assert out["checks"]["relres"]["value"] <= 1e-8


def test_the_readers_find_nothing_without_the_spans():
    units = [dict(timings=dict(pattern_s=1.0, assemble_s=0.5, solve_s=0.2),
                  iters=10)]
    rec = types.SimpleNamespace(units=units, timed=units, trace=None)
    for name in IC0_METRICS:
        assert registry.module("metrics", name).read(rec) is None, name


def test_a_program_that_runs_jacobi_is_refused_at_the_warm_up(monkeypatch):
    """The parent commit's solve_elasticity took `precond` and ran Jacobi
    on the reduced system whatever it said: such a program fails before
    the window."""
    orig = pfemfort_tpu_torch.solve_elasticity

    def jacobi_only(*a, precond="jacobi", **k):
        return orig(*a, **k)

    monkeypatch.setattr(pfemfort_tpu_torch, "solve_elasticity", jacobi_only)
    with pytest.raises(RuntimeError, match="'jacobi' where the mix asks "
                                           "for 'ic0'"):
        run.run_cell(BENCH, NAME, 2 ** 31 + 31, 0.05, trace=False,
                     device="cpu", config_patch=tiny())


def test_the_control_is_not_correct():
    """The plain reference's Jacobi-CG in bfloat16 (numbers/relres.py)."""
    cell = registry.Cell(BENCH, NAME, ROOT)
    tr = Traffic(dict(cell.config, **tiny()), cell.mix, 2 ** 31 + 3, "cpu")
    units = registry.module("numbers", "relres").control(tr, 2)
    assert not check.judge(tr, units, cell.limits)["correct"]


def _clamped_zero(res, args, kwargs):
    dbc = args[1]
    x0 = np.zeros_like(res.u_full)
    x0[dbc[:, 0].astype(np.int64) * 3 + dbc[:, 1].astype(np.int64)] = \
        dbc[:, 2]
    return res._replace(u_full=x0)


def _answer_altered(res, args, kwargs):
    u = res.u_full.copy()
    free = np.ones(len(u))
    dbc = args[1]
    free[dbc[:, 0].astype(np.int64) * 3 + dbc[:, 1].astype(np.int64)] = 0
    k = int(np.argmax(np.abs(u) * free))
    u[k] += np.abs(u).max()
    return res._replace(u_full=u)


def _unconverged(res, args, kwargs):
    return res._replace(stats=res.stats._replace(converged=False))


@pytest.mark.parametrize("fault", [_clamped_zero, _answer_altered,
                                   _unconverged],
                         ids=["state_unchanged", "answer_altered",
                              "unconverged"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    orig = pfemfort_tpu_torch.solve_elasticity
    monkeypatch.setattr(pfemfort_tpu_torch, "solve_elasticity",
                        lambda *a, **k: fault(orig(*a, **k), a, k))
    out = run.run_cell(BENCH, NAME, 2 ** 31 + 9, 0.05, trace=False,
                       device="cpu", config_patch=tiny())
    assert not out["correct"], out["checks"]
