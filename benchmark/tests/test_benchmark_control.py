"""The check fails what it must, at a size a test run holds (on the CPU).

  control      each cell's control (numbers/<number>.py: the reference in
               bfloat16 for the float32 cells, the port's own float32 path
               for the float64 one) comes out not correct;
  faults       a run with the timed path broken underneath comes out not
               correct: a step that returns its state unchanged, an
               answer altered where it is produced, and a solve that
               reports itself unconverged.  Two other faults a benchmark
               check may face have no place here: no cell averages over a
               batch, and no cell spans chips.

The sound runs beside them (test_benchmark_harness.py) pass the same
limits.  Run: python -m pytest benchmark/tests -q"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import pfemfort_tpu_torch  # noqa: E402
from pfemfort_tpu_torch.solve import highprec  # noqa: E402

from benchmark import run  # noqa: E402
from benchmark.harness import check, registry  # noqa: E402
from benchmark.harness.traffic import Traffic  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SIZE = {"poisson48m.mg_f64": 12, "elast64.cg_f32": 4, "elast64.explicit": 4}


def patches(name):
    n = SIZE[name]
    cell = registry.Cell(BENCH, name, ROOT)
    cfg = {"mesh": dict(cell.config["mesh"], cells=[n, n, n])}
    mix = dict(block_steps=200, warm_steps=5) \
        if "block_steps" in cell.mix else {}
    return cfg, mix


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = registry.Cell(BENCH, name, ROOT)
    cfg, mix = patches(name)
    tr = Traffic(dict(cell.config, **cfg), dict(cell.mix, **mix), 2 ** 31 + 3,
                 "cpu")
    units = registry.module("numbers", tr.entry.NUMBER).control(tr, 2)
    verdict = check.judge(tr, units, cell.limits)
    assert not verdict["correct"], verdict


def _fault_run(name, monkeypatch, fault):
    """A tiny run of the cell with its entry point broken by `fault`."""
    entry = registry.Cell(BENCH, name, ROOT).mix["entry"]
    cfg, mix = patches(name)
    if entry == "implicit":
        for fn in ("solve_poisson", "solve_elasticity"):
            orig = getattr(pfemfort_tpu_torch, fn)
            monkeypatch.setattr(
                pfemfort_tpu_torch, fn,
                lambda *a, _o=orig, **k: fault(entry, _o(*a, **k), a, k))
    elif entry == "box_1e8":
        orig = highprec.solve_box_poisson_1e8
        monkeypatch.setattr(highprec, "solve_box_poisson_1e8",
                            lambda *a, **k: fault(entry, orig(*a, **k), a, k))
    else:
        orig = pfemfort_tpu_torch.explicit_dynamics
        monkeypatch.setattr(pfemfort_tpu_torch, "explicit_dynamics",
                            lambda *a, **k: fault(entry, orig(*a, **k), a, k))
    return run.run_cell(BENCH, name, 2 ** 31 + 9, 0.05, trace=False,
                        device="cpu", config_patch=cfg, mix_patch=mix)


def _state_unchanged(entry, res, args, kwargs):
    """The solve returns its starting state (zero off the Dirichlet dofs),
    the explicit block the state it was given."""
    if entry == "explicit":
        s = kwargs.get("init_state")
        z = np.zeros_like(res.disp)
        return res._replace(disp=z if s is None else s.disp,
                            disp_prev=z if s is None else s.disp_prev,
                            velo=z if s is None else s.velo)
    dbc = args[1]
    nodes, dofs = dbc[:, 0].astype(np.int64), dbc[:, 1].astype(np.int64)
    if entry == "box_1e8":
        u, stats, timings = res
        x0 = np.zeros_like(u)
        x0[nodes] = dbc[:, 2]
        return x0, stats, timings
    ndof = len(res.u_full) // len(args[0].coords)
    x0 = np.zeros_like(res.u_full)
    x0[nodes * ndof + dofs] = dbc[:, 2]
    return res._replace(u_full=x0)


def _answer_altered(entry, res, args, kwargs):
    """One value of the answer moved by the answer's largest magnitude, at
    the free dof where the answer is largest."""
    if entry == "explicit":
        d = res.disp.copy()
        k = int(np.argmax(np.abs(d)))
        d[k] += np.abs(d).max()
        return res._replace(disp=d)
    u = (res[0] if entry == "box_1e8" else res.u_full).copy()
    k = int(np.argmax(np.abs(u) * _free(args, len(u))))
    u[k] += np.abs(u).max()
    if entry == "box_1e8":
        return (u,) + tuple(res[1:])
    return res._replace(u_full=u)


def _free(args, n):
    dbc = args[1]
    ndof = n // len(args[0].coords)
    free = np.ones(n)
    free[dbc[:, 0].astype(np.int64) * ndof + dbc[:, 1].astype(np.int64)] = 0
    return free


def _unconverged(entry, res, args, kwargs):
    """The solve returns its answer but reports it unconverged (an
    explicit block: a state that is not finite at one dof)."""
    if entry == "explicit":
        d = res.disp.copy()
        d[-1] = np.nan
        return res._replace(disp=d)
    if entry == "box_1e8":
        u, stats, timings = res
        return u, stats._replace(converged=False), timings
    return res._replace(stats=res.stats._replace(converged=False))


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _answer_altered,
                                   _unconverged],
                         ids=["state_unchanged", "answer_altered",
                              "unconverged"])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    out = _fault_run(name, monkeypatch, fault)
    assert not out["correct"], out["checks"]
