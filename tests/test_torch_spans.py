"""The port's spans and counters (utils/timing.py): what each driver's
timings hold inside its stages, when a span reaches the profiler, the
Krylov loops' reads, and the drivers' records in RECENT.  CPU only."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pfemfort_tpu_torch as pt
from pfemfort_tpu_torch import host_native
from pfemfort_tpu_torch.drivers.common import solve_implicit, \
    solve_implicit_fullsystem
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
from pfemfort_tpu_torch.solve import refine
from pfemfort_tpu_torch.solve.cg import bicgstab_solve, cg_solve
from pfemfort_tpu_torch.solve.highprec import solve_box_poisson_1e8
from pfemfort_tpu_torch.utils import device as device_mod
from pfemfort_tpu_torch.utils import timing

F64 = torch.float64
PATTERN = ("pattern.dofmap_s", "pattern.census_s", "pattern.plan_s",
           "pattern.coords_s")
KRYLOV = ("krylov.loop_s", "krylov.wait_s", "krylov.host_reads")
# the stage each dotted key sits in
PARENT = {"pattern": "pattern_s", "assemble": "host_assemble_s",
          "mg": "mg_setup_s", "krylov": "solve_s", "ic0": "ic0_setup_s",
          "explicit.setup": "explicit.setup_s"}
EXPLICIT_SETUP = ("explicit.setup.coords_s", "explicit.setup.plan_s")
IC0 = ("ic0.csr_s", "ic0.factor_s", "ic0.layout_s")


def _elasticity(n=3):
    """A box_tet clamped at x = 0: 3D elasticity takes the pattern path."""
    mesh, _ = pt.generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    nodes = np.where(mesh.coords[:, 0] < 1e-12)[0]
    dbc = np.concatenate([np.stack([nodes, np.full(len(nodes), d),
                                    np.zeros(len(nodes))], 1)
                          for d in range(3)])
    return mesh, dbc


def _solve_elasticity(**kw):
    mesh, dbc = _elasticity()
    return pt.solve_elasticity(mesh, dbc, 240.565, 0.3, bforce=(0.1, 0, 0),
                               device="cpu", **kw)


def _box(n=4):
    return pt.generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)


def _permuted_box(n=6):
    mesh, dbc = _box(n)
    perm = np.random.default_rng(0).permutation(mesh.n_node)
    inv = np.argsort(perm)
    m = pt.Mesh(mesh.etype, mesh.coords[perm], inv[mesh.conn])
    d = dbc.copy()
    d[:, 0] = inv[dbc[:, 0].astype(np.int64)]
    return m, d


def _poisson_fn(c):
    return poisson_element_matrices(c, "tetra4", source=-6.0)


def _fullsystem():
    mesh, dbc = _box()
    return solve_implicit_fullsystem(mesh, 1, dbc, _poisson_fn, device="cpu",
                                     dtype=F64, precond="mg")


def _ic0_ell_path():
    mesh, dbc = _permuted_box()
    return solve_implicit(mesh, 1, dbc, _poisson_fn, device="cpu", dtype=F64,
                          recover=False, precond="ic0")


def _explicit(nsteps=7):
    mesh, dbc = _elasticity()
    return pt.explicit_dynamics(mesh, dbc, 2.1e7, 0.1, 7.6, 2e-5, nsteps,
                                device="cpu", dtype=F64)


# (record name, call -> timings)
DRIVERS = {
    "pattern path": ("solve_implicit",
                     lambda: _solve_elasticity(dtype=F64).timings),
    "structured path": ("solve_implicit", lambda: pt.solve_poisson(
        *_box(), dtype=F64, device="cpu").timings),
    "ELL path": ("solve_implicit", lambda: pt.solve_poisson(
        *_permuted_box(), dtype=torch.float32, device="cpu",
        rtol=1e-6).timings),
    "ic0 pattern path": ("solve_implicit", lambda: _solve_elasticity(
        dtype=F64, precond="ic0").timings),
    "ic0 ELL path": ("solve_implicit", lambda: _ic0_ell_path().timings),
    "refined": ("solve_implicit_refined",
                lambda: _solve_elasticity(refine=True).timings),
    "full system mg": ("solve_implicit_fullsystem",
                       lambda: _fullsystem().timings),
    "matrix-free": ("solve_poisson_matfree", lambda: pt.solve_poisson(
        *_box(), dtype=F64, device="cpu", matrix_free=True).timings),
    "1e-8 box": ("solve_box_poisson_1e8",
                 lambda: solve_box_poisson_1e8(*_box(8), device="cpu")[2]),
    "explicit": ("explicit_dynamics", lambda: _explicit().timings),
}


@pytest.fixture
def no_record_function(monkeypatch):
    """Counts every record_function made; none may be made here."""
    made = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name))
    return made


# ---- the facility ----------------------------------------------------------
def test_spans_nest_and_accumulate():
    t = {}
    with timing.span("a_s", t):
        with timing.span("a.b_s", t):
            pass
        with timing.span("a.b_s", t):
            pass
    first = dict(t)
    with timing.span("a_s", t):
        pass
    assert set(t) == {"a_s", "a.b_s"}
    assert 0 <= first["a.b_s"] <= first["a_s"] < t["a_s"]
    timing.count("n", 3, t)
    timing.count("n", 4, t)
    assert t["n"] == 7
    with timing.span("kept_nowhere", None):
        pass
    assert timing.stage_seconds(t) == t["a_s"]


def test_a_span_records_its_time_when_its_block_raises():
    t = {}
    with pytest.raises(ValueError):
        with timing.span("x_s", t):
            raise ValueError("inside")
    assert t["x_s"] >= 0


def test_no_span_synchronises_or_profiles_without_a_profiler(
        monkeypatch, no_record_function):
    def refuse(*a, **k):
        raise AssertionError("a span synchronised")
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(device_mod, "synchronize", refuse)
    t = {}
    with timing.span("x_s", t):
        torch.ones(3).sum()
    timer = timing.Timer()
    with timer.phase("p", block_on=torch.ones(2)):
        pass
    r = _solve_elasticity(dtype=F64)
    assert r.stats.converged and no_record_function == []
    assert set(PATTERN) <= set(r.timings)


def test_spans_reach_the_profiler_while_it_runs():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r = _solve_elasticity(dtype=torch.float32, rtol=1e-6)
        with timing.span("x_s", None):
            pass
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith("pfem.")}
    assert names == {"pfem." + k for k in
                     PATTERN + ("pattern_s", "assemble_s", "solve_s",
                                "x_s")}
    assert timing.RECENT[-1] == ("solve_implicit", r.timings, True)


# ---- the Krylov loops --------------------------------------------------------
@pytest.fixture
def reads(monkeypatch):
    """Counts the device-to-host reads of tensors (bool, float, item)."""
    n = [0]
    for name in ("__bool__", "__float__", "item"):
        orig = getattr(torch.Tensor, name)

        def counted(self, _orig=orig):
            n[0] += 1
            return _orig(self)
        monkeypatch.setattr(torch.Tensor, name, counted)
    return n


def _spd(n=40, seed=0):
    g = torch.Generator().manual_seed(seed)
    m = torch.randn(n, n, dtype=F64, generator=g)
    A = m @ m.T + n * torch.eye(n, dtype=F64)
    return A, torch.randn(n, dtype=F64, generator=g)


@pytest.mark.parametrize("solver", [cg_solve, bicgstab_solve])
@pytest.mark.parametrize("maxiter", [1000, 5])
def test_host_reads_are_every_read_of_the_solve(solver, maxiter, reads):
    A, b = _spd()
    _, st = solver(lambda x: A @ x, b, rtol=1e-10, maxiter=maxiter)
    assert st.host_reads == reads[0]
    # one read a loop test (none at the exit that maxiter makes), then the
    # final relres and converged
    loop_tests = st.iters + (0 if st.iters == maxiter else 1)
    assert st.host_reads == loop_tests + 2
    assert st.converged == (maxiter == 1000)
    assert 0 <= st.wait_s <= st.loop_s


def test_stats_compare_by_result_alone():
    A, b = _spd()
    _, s1 = cg_solve(lambda x: A @ x, b, rtol=1e-10)
    _, s2 = cg_solve(lambda x: A @ x, b, rtol=1e-10)
    assert s1 == s2 and s1.loop_s > 0


def test_refined_counts_sum_over_the_inner_solves(monkeypatch, reads):
    inner = []

    def recorded(*a, **k):
        x, st = cg_solve(*a, **k)
        inner.append(st)
        return x, st
    monkeypatch.setattr(refine, "cg_solve", recorded)
    A, b = _spd(60, seed=1)
    A32 = A.to(torch.float32)
    before = reads[0]
    _, rs = refine.cg_with_refinement(lambda x: A @ x, lambda x: A32 @ x, b,
                                      rtol=1e-12, inner_rtol=1e-3)
    assert rs.converged and len(inner) == rs.outer_iters >= 2
    assert rs.total_inner_iters == sum(s.iters for s in inner)
    # b's norm, then each cycle's residual norm and largest entry, then
    # the last residual norm
    assert rs.host_reads == sum(s.host_reads for s in inner) \
        + 2 + 2 * rs.outer_iters == reads[0] - before
    assert rs.loop_s == pytest.approx(sum(s.loop_s for s in inner))
    assert rs.wait_s == pytest.approx(sum(s.wait_s for s in inner))
    r = _solve_elasticity(refine=True)
    t = r.timings
    assert t["krylov.host_reads"] == r.stats.host_reads \
        >= r.stats.iters + 3 * t["outer_iters"]


# ---- the drivers -------------------------------------------------------------
def test_the_pattern_paths_keys_are_the_table():
    t = _solve_elasticity(dtype=F64).timings
    assert set(t) == {"pattern_s", "assemble_s", "solve_s"} | set(PATTERN) \
        | set(KRYLOV)
    assert t["krylov.host_reads"] >= 3
    t = pt.solve_poisson(*_box(), dtype=F64, device="cpu").timings
    assert set(t) == {"pattern_s", "assemble_s", "solve_s",
                      "pattern.dofmap_s", "pattern.coords_s"} | set(KRYLOV)
    _, _, t = solve_box_poisson_1e8(*_box(8), device="cpu")
    assert {"host_assemble_s", "assemble.affine_s", "mg_setup_s",
            "mg.coarsen_s", "solve_s"} | set(KRYLOV) <= set(t)


def test_the_pattern_paths_census_runs_in_the_host_library(monkeypatch):
    """The DIA path's two census passes (the head probe and the whole
    mesh) both run in the host library, inside pattern.census_s; an ELL
    mesh stops after the probe."""
    calls = []
    census = host_native.offset_census

    def counted(elem_dof, n_rows):
        calls.append(len(elem_dof))
        return census(elem_dof, n_rows)

    monkeypatch.setattr(host_native, "offset_census", counted)
    t = _solve_elasticity(dtype=F64).timings
    assert len(calls) == 2 and calls[1] == _elasticity()[0].n_elem
    assert 0 < t["pattern.census_s"] <= t["pattern_s"]
    calls.clear()
    mesh, dbc = _permuted_box()
    t = solve_implicit(mesh, 1, dbc, _poisson_fn, device="cpu", dtype=F64,
                       recover=False).timings
    assert len(calls) == 1 and "order_s" in t


@pytest.mark.parametrize("case", ["ic0 pattern path", "ic0 ELL path"])
def test_the_ic0_set_up_spans_and_counters(case):
    """IC(0)'s set-up: its three child spans inside ic0_setup_s, T's entry
    count and the form each of T and T^T was routed to."""
    t = DRIVERS[case][1]()
    assert ("order_s" in t) == (case == "ic0 ELL path")
    assert set(IC0) <= set(t) and t["precond_used"] == "ic0"
    assert all(t[k] > 0 for k in IC0)
    assert sum(t[k] for k in IC0) <= t["ic0_setup_s"]
    assert t["ic0.t_nnz"] > 0 and isinstance(t["ic0.t_nnz"], int)
    assert len(t["ic0.route"]) == 2
    assert set(t["ic0.route"]) <= {"dia", "ell", "hybrid", "dense"}


@pytest.mark.parametrize("case", sorted(DRIVERS))
def test_children_never_exceed_their_stage_and_the_driver_records(case):
    name, call = DRIVERS[case]
    t = call()
    for prefix, stage in PARENT.items():
        kids = [v for k, v in t.items()
                if k.startswith(prefix + ".") and k.endswith("_s")]
        if kids:
            assert sum(kids) <= t[stage], (prefix, t)
    assert timing.RECENT[-1] == (name, t, False)


def test_the_explicit_result_carries_its_spans():
    res = _explicit(nsteps=7)
    t = res.timings
    assert set(t) == {"explicit.setup_s", "explicit.loop_s", "steps",
                      "explicit.kernel_steps", "explicit.hg_kernel_steps",
                      "explicit.setup_h2d_bytes"} | set(EXPLICIT_SETUP)
    assert t["steps"] == 7 and t["explicit.setup_s"] > 0 \
        and t["explicit.loop_s"] > 0
    assert all(t[k] > 0 for k in EXPLICIT_SETUP)
    assert sum(t[k] for k in EXPLICIT_SETUP) <= t["explicit.setup_s"]
    assert t["explicit.kernel_steps"] == 0      # the CPU runs no kernel
    assert t["explicit.hg_kernel_steps"] == 0
    assert t["explicit.setup_h2d_bytes"] == 0   # nor sends anything
    rec = timing.RECENT[-1]
    assert rec.name == "explicit_dynamics" and rec.timings is t \
        and rec.profiled is False


def test_the_explicit_set_ups_children_sit_inside_it_in_the_profile():
    """Under a profiler each child's range lies inside its parent's range
    and outside the loop's."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _explicit(nsteps=3)
    at = {e.name()[len("pfem."):]: (e.start_ns(), e.end_ns())
          for e in prof.profiler.kineto_results.events()
          if e.name().startswith("pfem.")}
    assert set(at) == {"explicit.setup_s", "explicit.loop_s"} \
        | set(EXPLICIT_SETUP)
    (s0, s1), (l0, _) = at["explicit.setup_s"], at["explicit.loop_s"]
    for k in EXPLICIT_SETUP:
        assert s0 <= at[k][0] <= at[k][1] <= s1 <= l0, k
    assert at["explicit.setup.coords_s"][1] <= at["explicit.setup.plan_s"][0]
    assert timing.RECENT[-1].profiled is True


def test_recent_keeps_the_last_32():
    for _ in range(33):
        timing.record("x", {})
    assert len(timing.RECENT) == 32
