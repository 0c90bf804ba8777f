# Ported from bench.py (the JAX package's bench harness): its seven stages on the port's entry points; no JAX, no TPU timing workarounds.
"""The port's bench harness: seven stages, one JSON result line last.

    python -m pfemfort_tpu_torch.bench [n] [n_large] [n_large_unstr]
        [--device cuda|cpu] [--detail PATH] [--budget-s S]
    python -m pfemfort_tpu_torch bench [n] ...        (the CLI's subcommand)

n, n_large and n_large_unstr default to 96, 200 and 160 (0 skips the
stage of that size).  Headline metric: the SpMV rate (nonzeros per
second) of kernel B1 on the flagship's box_tet Poisson system, the hot loop
of the reference's KSPSolve.  The stages, in this order, each on the
port's own entry points:

  flagship            box_tet n, float32: the structured and the general
                      (pattern) assembly rates, B1's SpMV rate, Jacobi-CG
                      (solve_poisson), the full-system GMG solve, the
                      refined solve (refine=True: float32 inner, true
                      float64 outer) and solve_box_poisson_1e8;
  partition_quality   the edge cuts of RCB, greedy and a random balanced
                      partition into 8 parts of a jittered Delaunay mesh
                      (n=24, default_rng(11), 93,980 elements);
  large               box_tet n_large: Jacobi-CG float32, the refined
                      solve and solve_box_poisson_1e8; the assembly's
                      elements/s and the solve's nonzeros/s;
  unstructured        box_tet max(n, 16) renumbered by default_rng(0) on
                      the ELL path (recover=False, the hybrid operator);
                      B2's SpMV rate on that system in the solve's row order
                      and unordered;
  amg                 box_tet max(n, 16) renumbered by default_rng(2),
                      SA-AMG against Jacobi, time to solution;
  large_unstructured  box_tet n_large_unstr renumbered by default_rng(0):
                      the general ELL pattern, its row order and the hybrid,
                      scatter assembly and Jacobi-CG in float32;
  dist_spmv           the shard-local SpMVs at one rank's shape, built
                      without a process group: B1's halo entry on the
                      world-size-1 slab block of box_tet n; B2 on the
                      ghost-extended block of rank 1 of an 8-way RCB
                      partition of box_tet n renumbered by default_rng(0);
                      and that rank's per-rank hybrid (the float32 ELL
                      route's operator): B1 on its dense local diagonals,
                      B2 on its remainder.  On the card each also beside
                      the library's product of the same block (cuSPARSE).

Bars are the JAX package's counts (BENCH_DETAIL.json, its tests), never
its TPU times; at other sizes a stage holds convergence, relres and the
nodal error against u = x^2+y^2+z^2.  A stage that fails or misses a bar
records `error` and the run goes on to the next; the process exits 1 if
any stage did.  Each stage runs under its own time cap (SIGALRM) and the
budget `--budget-s`; its stage seconds (pattern_s, order_s, set-up,
assemble_s, solve_s) end in a device synchronise.  On the card, kernel
times are device times from CUDA events with the host's cost hidden
(utils/timing.py:device_ms), beside the byte bound at the card's
data-sheet HBM peak; on the CPU the plain versions are timed on the host
clock and no bound is given.  Every entry-point call is counted: the
launches of B1 and B2 it made (timing launches are not counted).

Output: a result line after every stage and last (`metric`, `value`,
`unit`, `stages`, `summary`, `detail_file`, `card`); the full detail in
BENCH_TORCH_DETAIL.json beside the repository's root (or --detail PATH),
and the running partial in BENCH_TORCH_PARTIAL.json beside it.
"""

from __future__ import annotations

import argparse
import json
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from pfemfort_tpu_torch import host_native
from pfemfort_tpu_torch.assembly.assemble import assemble_ell_values, \
    assemble_matrix, assemble_rhs, build_assembly_plan, \
    dirichlet_rhs_correction
from pfemfort_tpu_torch.assembly.pattern import build_pattern
from pfemfort_tpu_torch.dofs.dofmap import build_dofmap, reduced_lattice
from pfemfort_tpu_torch.drivers.common import build_ell_ordering, \
    build_reduced_assembler, solve_implicit
from pfemfort_tpu_torch.drivers.poisson import solve_poisson
from pfemfort_tpu_torch.elements.geometry import box_element_coords, \
    element_coords
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
from pfemfort_tpu_torch.mesh import generate
from pfemfort_tpu_torch.mesh.core import Mesh
from pfemfort_tpu_torch.parallel.dist_ell import hybrid_counts, \
    hybrid_offsets, hybrid_split, local_columns, reader_plan
from pfemfort_tpu_torch.parallel.partition import partition_elements
from pfemfort_tpu_torch.parallel.shard import build_sharded_system
from pfemfort_tpu_torch.solve.highprec import solve_box_poisson_1e8
from pfemfort_tpu_torch.sparse import dia_spmv_cuda, ell_spmv_cuda
from pfemfort_tpu_torch.sparse.dia import DIAMatrix, spmv_dia, \
    spmv_dia_halo_local
from pfemfort_tpu_torch.sparse.formats import round_up
from pfemfort_tpu_torch.sparse.hybrid import hybrid_layout
from pfemfort_tpu_torch.sparse.sliced import ell_to_sliced, slice_ell, \
    unslice
from pfemfort_tpu_torch.sparse.spmv import spmv_sliced
from pfemfort_tpu_torch.utils.timing import device_ms, library_csr, \
    peak_gbps, spmv_bound, stage_seconds

ROOT = Path(__file__).resolve().parents[1]
BASELINE_NNZ_PER_S = 1.0e9     # PETSc MPIAIJ SpMV on one CPU socket, est.
STAGES = ("flagship", "partition_quality", "large", "unstructured", "amg",
          "large_unstructured", "dist_spmv")
STAGE_CAP_S = {"flagship": 280.0, "partition_quality": 60.0, "large": 400.0,
               "unstructured": 240.0, "amg": 240.0,
               "large_unstructured": 500.0, "dist_spmv": 150.0}
RTOL = 1e-6
# The JAX package's counts by box size (BENCH_DETAIL.json; the slack is
# chip_smoke.py's).  flagship: Jacobi-CG, GMG and solve_box_poisson_1e8
# (outer, inner); large: Jacobi-CG; large_unstructured: rows, nonzeros and
# Jacobi-CG; amg: the levels.
FLAGSHIP_BARS = {96: dict(iters=(271, 10), mg=(7, 1), hp=(2, 13))}
LARGE_BARS = {200: dict(iters=(546, 15), refined_outer=2)}
LU_BARS = {160: dict(rows=4_019_679, nnz=59_690_347, iters=(440, 15))}
AMG_LEVELS = {96: [857375, 107983, 38008, 542]}
AMG_ITERS_MAX = 20
# Nodal error bars.  `large` (box_tet n=200, float32 Jacobi-CG to rtol
# 1e-6) sits on the JAX package's own float32 floor at that size: 1.25 x
# the larger of its two CPU values, 3.66e-4 (the JAX bench sets no nodal
# bar; the 3e-4 this bar replaces was drawn from its TPU run's 2.2e-4).
# solve_poisson, box_tet, float32, Jacobi-CG, on the CPU
# (tests/test_torch_nodal_floor.py holds the n=48 floors together):
#     n    rtol   port: iterations, nodal    JAX: iterations, nodal
#     48   1e-6   140, 1.38e-5               159, 9.54e-6
#     48   1e-7   167, 1.05e-5               188, 1.02e-5
#     48   1e-8   192, 1.01e-5               213, 1.02e-5
#     200  1e-6   546, 3.75e-4               740, 2.83e-4
#     200  1e-7   694, 3.94e-4               903, 3.66e-4
NODAL = {"flagship": 2e-4, "large": 4.6e-4, "large_unstructured": 3e-4,
         "unstructured": 2e-4, "amg": 2e-4, "1e8": 1e-6}
PARTITION_CUTS = {"rcb": 3539, "greedy": 8911, "random": 161549}
PARTS = 8
REL_ERR_MAX = {torch.float32: 1e-5, torch.float64: 1e-12}


class StageTimeout(Exception):
    pass


class BarMissed(Exception):
    pass


def _log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _san(obj):
    """Strict JSON: inf/nan -> None, numpy scalars -> Python."""
    if isinstance(obj, dict):
        return {str(k): _san(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_san(v) for v in obj]
    if isinstance(obj, np.generic):
        obj = obj.item()
    if isinstance(obj, float) and not np.isfinite(obj):
        return None
    return obj


def _poisson_fn(coords_em):
    return poisson_element_matrices(coords_em, "tetra4", source=-6.0)


def _box(n):
    return generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)


def _permuted_box(n, seed):
    """box_tet n with its nodes renumbered by default_rng(seed): no
    structure left."""
    mesh, dbc = _box(n)
    perm = np.random.default_rng(seed).permutation(mesh.n_node)
    mesh = mesh.renumbered(perm.astype(np.int64))
    dbc = dbc.copy()
    dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    return mesh, dbc


def _nodal(res_u, mesh):
    return float(np.abs(res_u - (mesh.coords ** 2).sum(axis=1)).max())


KERNELS = {"dia_spmv": dia_spmv_cuda.kernel, "ell_spmv": ell_spmv_cuda.kernel}


def launch_counts(kernels) -> dict:
    """Launches of each kernel since its count was set to 0, and of them
    those of B1's halo entry (dia_spmv_halo)."""
    out = {name: k.launches for name, k in kernels.items()}
    out["dia_spmv_halo"] = sum(
        v for e, v in kernels["dia_spmv"].entry_launches.items()
        if e.startswith("dia_spmv_halo"))
    return out


class Bench:
    """One run: its device, clock, budget, detail and output paths."""

    def __init__(self, device: torch.device, budget_s: float,
                 detail_path: Path):
        self.device = device
        self.cuda = device.type == "cuda"
        self.budget_s = budget_s
        self.detail_path = detail_path
        detail_path.parent.mkdir(parents=True, exist_ok=True)
        self.partial_path = detail_path.parent / "BENCH_TORCH_PARTIAL.json"
        self.t0 = time.perf_counter()
        self.detail = {}
        self.card = None
        self.peak = None
        if self.cuda:
            self.card = _nvidia_smi()
            self.peak = peak_gbps(torch.cuda.get_device_name(device))
        self.nnz_per_s = 0.0

    # ---- clocks and counts ------------------------------------------------
    def remaining(self) -> float:
        return self.budget_s - (time.perf_counter() - self.t0)

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def counted(self, d, label, fn):
        """Run an entry point with B1's and B2's launch counts set to 0
        just before and read just after; record them in d['launches']."""
        for k in KERNELS.values():
            k.launches = 0
            k.entry_launches.clear()
        out = fn()
        self.sync()
        d.setdefault("launches", {})[label] = launch_counts(KERNELS)
        return out

    def seconds(self, fn, reps=3):
        """Best host seconds of fn() over reps runs, each ending in a
        device synchronise (the first run warms up and is not counted)."""
        fn()
        self.sync()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            self.sync()
            best = min(best, time.perf_counter() - t0)
        return best

    def spmv_rate(self, product, plain, A, nnz, halo=0, x=None):
        """One SpMV y = product() against its plain version and timed:
        device µs of both (card, host hidden) beside the byte bound, or
        host µs (CPU, the plain version); nonzeros per second.  With `x`,
        the product's input, the card also times the library's product of
        the same matrix (utils/timing.py:library_csr; cuSPARSE)."""
        y, y_ref = product(), plain()
        rel = float((y - y_ref).abs().max()) / max(
            float(y_ref.abs().max()), 1e-300)
        out = dict(nnz=int(nnz), dtype=str(A.vals.dtype)[6:],
                   max_rel_err_vs_plain=rel)
        if self.cuda:
            device_ms(product, reps=10)                  # warm
            ms, hidden = device_ms(product)
            bound_ms, bound_by, nbytes = spmv_bound(A, nnz, self.peak, halo)
            device_ms(plain, reps=10)
            out.update(clock="cuda_events", device_us=1e3 * ms,
                       plain_us=1e3 * device_ms(plain)[0],
                       bound_us=1e3 * bound_ms, bound_by=bound_by,
                       bytes=nbytes, peak_gbps=self.peak,
                       share_of_bound=bound_ms / ms, host_hidden=hidden,
                       gbps=nbytes / (ms * 1e-3) / 1e9)
            if x is not None:
                csr, _ = library_csr(A)
                library = lambda: csr @ x
                device_ms(library, reps=10)
                lib_ms, _ = device_ms(library)
                out.update(library_us=1e3 * lib_ms,
                           library_rel_err=float(
                               (library() - y).abs().max()) / max(
                                   float(y.abs().max()), 1e-300))
        else:
            ms = 1e3 * self.seconds(product, reps=5)
            out.update(clock="host", host_us=1e3 * ms)
        out["nnz_per_s"] = nnz / (ms * 1e-3)
        return out, rel <= REL_ERR_MAX[A.vals.dtype]

    # ---- output -----------------------------------------------------------
    def flush_partial(self, stage):
        with open(self.partial_path, "w") as f:
            json.dump(_san({"stage_done": stage,
                            "elapsed_s": time.perf_counter() - self.t0,
                            "detail": self.detail}), f)
        _log(f"DONE {stage}: "
             + json.dumps(_san(self.detail.get(stage, {})))[:900])

    def result_line(self) -> str:
        def ok(name):
            d = self.detail.get(name)
            return isinstance(d, dict) and "error" not in d \
                and "skipped" not in d

        def pick(stage, key):
            d = self.detail.get(stage)
            return d.get(key) if isinstance(d, dict) else None

        summary = {
            "flagship_cg_iters": pick("flagship", "cg_iters"),
            "flagship_spmv_share_of_bound": (pick("flagship", "spmv") or {}
                                             ).get("share_of_bound"),
            "large_refined_relres": pick("large", "refined_relres"),
            "large_cg_nnz_per_s": pick("large", "cg_nnz_per_s"),
            "unstructured_cg_iters": pick("unstructured", "cg_iters"),
            "amg_speedup_vs_jacobi": pick("amg", "speedup_vs_jacobi"),
            "large_unstructured_cg_iters": pick("large_unstructured",
                                                "cg_iters"),
            "large_unstructured_s": pick("large_unstructured", "total_s"),
            "elapsed_s": time.perf_counter() - self.t0,
        }
        return json.dumps(_san({
            "metric": "spmv_nnz_per_s",
            "value": float(self.nnz_per_s),
            "unit": "nnz/s",
            "vs_baseline": float(self.nnz_per_s / BASELINE_NNZ_PER_S),
            "stages": {st: ok(st) for st in STAGES if st in self.detail},
            "summary": {k: v for k, v in summary.items() if v is not None},
            "detail_file": str(self.detail_path),
            "device": str(self.device),
            "card": self.card,
        }))


def _nvidia_smi():
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as ex:
        return f"{torch.cuda.get_device_name(0)} (nvidia-smi: {ex})"


class stage_guard:
    """SIGALRM stage timeout: the stage raises StageTimeout in this
    process, which records it and goes on (the JAX harness's
    `stage_guard`, bench.py:56).  The timer repeats every 20 s in case a
    library swallows the first raise; it is disarmed on exit."""

    def __init__(self, name, cap_s):
        self.name = name
        self.cap = max(int(cap_s), 1)

    def __enter__(self):
        def handler(signum, frame):
            raise StageTimeout(f"{self.name} exceeded {self.cap}s")
        self._old = signal.signal(signal.SIGALRM, handler)
        signal.setitimer(signal.ITIMER_REAL, self.cap, 20.0)
        return self

    def __exit__(self, *exc):
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, self._old)
        return False


def _bar(d, name, ok, value, want):
    """Record one bar of a stage: its value, what it must be, whether it
    holds."""
    d.setdefault("bars", {})[name] = {"ok": bool(ok), "value": value,
                                      "want": want}


def _band(d, name, value, bars, key):
    """A count within (want, slack) of bars[key], when bars has it."""
    if bars and key in bars:
        want, slack = bars[key]
        _bar(d, name, abs(value - want) <= slack, value,
             f"{want} +- {slack}")


def _solve_fields(r, mesh=None):
    """The stage fields of an ImplicitResult: iterations, relres, nodal
    error (with `mesh`), the timings, time to solution, ms an
    iteration."""
    it = int(r.stats.iters)
    out = dict(iters=it, relres=float(r.stats.relres),
               converged=bool(r.stats.converged),
               time_to_solution_s=stage_seconds(r.timings),
               ms_per_iter=1e3 * r.timings["solve_s"] / max(it, 1),
               timings=dict(r.timings))
    if mesh is not None:
        out["nodal_err"] = _nodal(r.u_full, mesh)
    return out


def _dia_nnz(A) -> int:
    """Nonzero in-range entries of a DIA matrix."""
    dev = A.vals.device
    rows = torch.arange(A.n_rows, device=dev)
    n = 0
    for d, o in enumerate(A.offsets):
        c = rows + o
        n += int(((c >= 0) & (c < A.n_rows) & (A.vals[d] != 0)).sum())
    return n


def _peak_reset(b):
    if b.cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(b.device)


def _peak(b, d):
    d["peak_device_bytes"] = (torch.cuda.max_memory_allocated(b.device)
                              if b.cuda else None)


def _check_bars(d):
    missed = [f"{k}: {v['value']} (want {v['want']})"
              for k, v in d.get("bars", {}).items() if not v["ok"]]
    if missed:
        raise BarMissed("; ".join(missed))


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

def flagship(b: Bench, n: int):
    d = b.detail.setdefault("flagship", {})
    dev, f32 = b.device, torch.float32
    bars = FLAGSHIP_BARS.get(n)
    t0 = time.perf_counter()
    mesh, dbc = _box(n)
    dofmap = build_dofmap(mesh, 1, dbc, with_elem=False)
    assemble = build_reduced_assembler(mesh, 1, dofmap, _poisson_fn, f32, dev)
    coords = box_element_coords(mesh, ((0, 1),) * 3, f32, dev)
    b.sync()
    d.update(mesh=f"tet {n}x{n}x{n}x6 = {mesh.n_elem} elems",
             n_elem=int(mesh.n_elem), n_dof=int(dofmap.total_dof),
             setup_s=time.perf_counter() - t0)

    A, rhs = assemble(coords)
    t = b.seconds(lambda: assemble(coords))
    d.update(structured_assembly_s=t,
             structured_assembly_elems_per_s=mesh.n_elem / t)

    t0 = time.perf_counter()
    full = build_dofmap(mesh, 1, dbc)
    pattern = build_pattern(full.elem_dof, full.total_dof,
                            lattice=reduced_lattice(mesh, full))
    plan = build_assembly_plan(pattern, dev)
    ubc_e = torch.as_tensor(full.bc_values_full[full.elem_nodedof].T,
                            dtype=f32, device=dev)
    b.sync()
    d["general_pattern_s"] = time.perf_counter() - t0

    def general():
        Ke, Fe = _poisson_fn(coords)
        return assemble_matrix(Ke, plan), assemble_rhs(
            Fe + dirichlet_rhs_correction(Ke, ubc_e), plan)

    _, b_gen = general()
    d["structured_vs_general_rhs_err"] = float((b_gen - rhs).abs().max())
    del b_gen
    t = b.seconds(general, reps=2)
    d.update(general_assembly_s=t, general_assembly_elems_per_s=mesh.n_elem
             / t, general_layout=pattern.layout)
    del plan, pattern, ubc_e, full

    nnz = _dia_nnz(A)
    x = torch.ones(A.n_rows, dtype=f32, device=dev)
    d.update(nnz=nnz, dia_offsets=len(A.offsets))
    d["spmv"], ok = b.spmv_rate(lambda: dia_spmv_cuda.dia_spmv(A, x),
                                lambda: spmv_dia(A, x), A, nnz)
    _bar(d, "b1_vs_plain", ok, d["spmv"]["max_rel_err_vs_plain"],
         f"<= {REL_ERR_MAX[f32]}")
    b.nnz_per_s = d["spmv"]["nnz_per_s"]
    del A, rhs, coords, x

    r = b.counted(d, "jacobi", lambda: solve_poisson(
        mesh, dbc, device=dev, dtype=f32, rtol=RTOL))
    s = _solve_fields(r, mesh)
    d.update(cg_iters=s["iters"], cg_relres=s["relres"],
             cg_nodal_err=s["nodal_err"], cg=s)
    _bar(d, "cg_converged", s["converged"] and s["relres"] <= RTOL,
         s["relres"], f"<= {RTOL}")
    _bar(d, "cg_nodal_err", s["nodal_err"] <= NODAL["flagship"],
         s["nodal_err"], f"<= {NODAL['flagship']}")
    _band(d, "cg_iters", s["iters"], bars, "iters")

    r = b.counted(d, "mg", lambda: solve_poisson(
        mesh, dbc, device=dev, dtype=f32, rtol=RTOL, maxiter=100,
        bc_mode="full", precond="mg"))
    s = _solve_fields(r, mesh)
    d.update(mg_cg_iters=s["iters"], mg=s)
    _bar(d, "mg_used", r.timings.get("precond_used") == "mg"
         and s["converged"], r.timings.get("precond_used"), "mg, converged")
    _band(d, "mg_cg_iters", s["iters"], bars, "mg")

    r = b.counted(d, "refined", lambda: solve_poisson(
        mesh, dbc, device=dev, refine=True, rtol=1e-8))
    s = _solve_fields(r, mesh)
    d.update(refined_outer_iters=int(r.timings["outer_iters"]),
             refined_inner_iters=s["iters"], refined_relres_f64=s["relres"],
             refined=s)
    _bar(d, "refined_relres", s["converged"] and s["relres"] <= 1e-8,
         s["relres"], "<= 1e-8")

    t0 = time.perf_counter()
    u, rs, tm = b.counted(d, "1e8", lambda: solve_box_poisson_1e8(
        mesh, dbc, rtol=1e-8, device=dev))
    hp = dict(outer_iters=int(rs.outer_iters),
              inner_iters=int(rs.total_inner_iters),
              relres_f64=float(rs.relres), converged=bool(rs.converged),
              nodal_err=_nodal(u, mesh), total_s=time.perf_counter() - t0,
              timings=tm)
    d["highprec_1e8"] = hp
    _bar(d, "1e8_relres", hp["converged"] and hp["relres_f64"] <= 1e-8,
         hp["relres_f64"], "<= 1e-8")
    if bars:
        _bar(d, "1e8_outer_inner", (hp["outer_iters"], hp["inner_iters"])
             == bars["hp"], [hp["outer_iters"], hp["inner_iters"]],
             list(bars["hp"]))


def partition_quality(b: Bench):
    """The JAX harness's partition-quality stage (bench.py:1101): the same
    rng(11) Delaunay mesh, the port's native partitioners and edge cut."""
    d = b.detail.setdefault("partition_quality", {})
    mesh, rng = delaunay_mesh()
    d.update(n_elem=int(mesh.n_elem), n_parts=PARTS)
    for method in ("rcb", "greedy"):
        t0 = time.perf_counter()
        part = partition_elements(mesh, PARTS, method=method)
        d[f"{method}_partition_s"] = time.perf_counter() - t0
        d[f"{method}_edge_cut"] = host_native.edge_cut(mesh.conn,
                                                       mesh.n_node, 3, part)
    rand = rng.permutation(np.arange(mesh.n_elem) % PARTS).astype(np.int32)
    d["random_edge_cut"] = host_native.edge_cut(mesh.conn, mesh.n_node, 3,
                                                rand)
    for m in ("rcb", "greedy"):
        d[f"{m}_vs_random"] = d[f"{m}_edge_cut"] / d["random_edge_cut"]
    for m, want in PARTITION_CUTS.items():
        _bar(d, f"{m}_edge_cut", d[f"{m}_edge_cut"] == want,
             d[f"{m}_edge_cut"], want)


def delaunay_mesh(n=24, seed=11):
    """The partition-quality mesh (bench.py:1114-1129): Delaunay tets of
    the (n+1)^3 lattice with its interior jittered by default_rng(seed);
    returns the mesh and the generator, which the random partition goes
    on drawing from."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    g = np.linspace(0, 1, n + 1)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    pts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    interior = ((pts > 1e-9) & (pts < 1 - 1e-9)).all(axis=1)
    pts[interior] += rng.uniform(-0.25, 0.25, (int(interior.sum()), 3)) / n
    conn = Delaunay(pts).simplices.astype(np.int64)
    a, bb, c, dd = (pts[conn[:, i]] for i in range(4))
    vol6 = np.einsum("ij,ij->i", np.cross(bb - a, c - a), dd - a)
    conn[vol6 < 0] = conn[vol6 < 0][:, [0, 2, 1, 3]]
    conn = conn[np.abs(vol6) > 1e-12]
    return Mesh("tetra4", pts, conn.astype(np.int32)), rng


def large(b: Bench, n: int):
    d = b.detail.setdefault("large", {})
    dev, f32 = b.device, torch.float32
    bars = LARGE_BARS.get(n)
    t0 = time.perf_counter()
    mesh, dbc = _box(n)
    d.update(mesh=f"tet {n}x{n}x{n}x6 = {mesh.n_elem} elems",
             n_elem=int(mesh.n_elem), mesh_s=time.perf_counter() - t0)

    # the structured assembly alone (coordinates made on the device): its
    # elements/s and the matrix's nonzeros
    dofmap = build_dofmap(mesh, 1, dbc, with_elem=False)
    assemble = build_reduced_assembler(mesh, 1, dofmap, _poisson_fn, f32, dev)
    coords = box_element_coords(mesh, ((0, 1),) * 3, f32, dev)
    A, _ = assemble(coords)
    d.update(n_dof=int(A.n_rows), nnz=_dia_nnz(A),
             assembly_chunks=getattr(assemble, "n_chunks", 1))
    del A
    t = b.seconds(lambda: assemble(coords), reps=1)
    d.update(assembly_s=t, assembly_elems_per_s=mesh.n_elem / t)
    del coords, assemble
    _peak_reset(b)

    r = b.counted(d, "jacobi", lambda: solve_poisson(
        mesh, dbc, device=dev, dtype=f32, rtol=RTOL))
    s = _solve_fields(r, mesh)
    d.update(cg_iters=s["iters"], cg_relres=s["relres"],
             nodal_err_vs_exact=s["nodal_err"], cg=s,
             cg_nnz_per_s=d["nnz"] * s["iters"] / r.timings["solve_s"],
             solve_assemble_elems_per_s=mesh.n_elem
             / r.timings["assemble_s"])
    _bar(d, "cg_converged", s["converged"] and s["relres"] <= RTOL,
         s["relres"], f"<= {RTOL}")
    _bar(d, "cg_nodal_err", s["nodal_err"] <= NODAL["large"],
         s["nodal_err"], f"<= {NODAL['large']}")
    _band(d, "cg_iters", s["iters"], bars, "iters")
    del r

    r = b.counted(d, "refined", lambda: solve_poisson(
        mesh, dbc, device=dev, refine=True, rtol=1e-8))
    s = _solve_fields(r, mesh)
    d.update(refined_outer_iters=int(r.timings["outer_iters"]),
             refined_inner_iters=s["iters"], refined_relres=s["relres"],
             refined=s)
    _bar(d, "refined_relres", s["converged"] and s["relres"] <= 1e-8,
         s["relres"], "<= 1e-8")
    if bars:
        _bar(d, "refined_outer", d["refined_outer_iters"]
             == bars["refined_outer"], d["refined_outer_iters"],
             bars["refined_outer"])
    del r

    t0 = time.perf_counter()
    u, rs, tm = b.counted(d, "1e8", lambda: solve_box_poisson_1e8(
        mesh, dbc, rtol=1e-8, device=dev))
    hp = dict(outer_iters=int(rs.outer_iters),
              inner_iters=int(rs.total_inner_iters),
              relres_f64=float(rs.relres), converged=bool(rs.converged),
              nodal_err=_nodal(u, mesh), total_s=time.perf_counter() - t0,
              timings=tm)
    d["highprec_1e8"] = hp
    _bar(d, "1e8", hp["converged"] and hp["relres_f64"] <= 1e-8
         and hp["outer_iters"] <= 6 and hp["nodal_err"] <= NODAL["1e8"],
         [hp["relres_f64"], hp["outer_iters"], hp["nodal_err"]],
         "relres <= 1e-8, <= 6 outer, nodal <= 1e-6")
    _peak(b, d)


def _lattice_iters(b: Bench, n: int) -> int:
    """The float32 Jacobi-CG count of the lattice box n: the flagship's
    when it ran at n, else solved here."""
    fl = b.detail.get("flagship", {})
    if fl.get("n_elem") == 6 * n ** 3 and "cg_iters" in fl:
        return int(fl["cg_iters"])
    mesh, dbc = _box(n)
    return int(solve_poisson(mesh, dbc, device=b.device,
                             dtype=torch.float32, rtol=RTOL).stats.iters)


def unstructured(b: Bench, n: int):
    d = b.detail.setdefault("unstructured", {})
    dev, f32 = b.device, torch.float32
    mesh, dbc = _permuted_box(n, 0)
    d["mesh"] = f"permuted tet {n}^3 x6 = {mesh.n_elem} elems"
    r = b.counted(d, "jacobi", lambda: solve_implicit(
        mesh, 1, dbc, _poisson_fn, device=dev, dtype=f32, rtol=RTOL,
        recover=False))
    s = _solve_fields(r, mesh)
    lat = _lattice_iters(b, n)
    d.update(n_dof=int(r.u_reduced.numel()), cg_iters=s["iters"],
             lattice_cg_iters=lat, cg=s,
             **{k: r.timings[k] for k in r.timings
                if k in ("pattern_s", "order_s", "ordering", "assemble_s",
                         "solve_s") or k.startswith("hybrid_")})
    _bar(d, "ell_path", "order_s" in r.timings, sorted(r.timings),
         "order_s")
    _bar(d, "cg_converged", s["converged"] and s["relres"] <= RTOL,
         s["relres"], f"<= {RTOL}")
    _bar(d, "cg_nodal_err", s["nodal_err"] <= NODAL["unstructured"],
         s["nodal_err"], f"<= {NODAL['unstructured']}")
    _bar(d, "cg_iters_eq_lattice", s["iters"] == lat, s["iters"], lat)
    _bar(d, "hybrid_nnz_rem", r.timings.get("hybrid_nnz_rem") == 0,
         r.timings.get("hybrid_nnz_rem"), 0)
    del r

    # B2 on the same system: in the solve's row order and unordered
    t0 = time.perf_counter()
    dofmap = build_dofmap(mesh, 1, dbc)
    assemble = build_reduced_assembler(mesh, 1, dofmap, _poisson_fn, f32, dev)
    coords = element_coords(mesh, f32, dev)
    ordering = build_ell_ordering(assemble.pattern,
                                  mesh.coords[dofmap.assy_for_soln],
                                  dofmap.assy_for_soln % 1, dev)
    A_un, b_un = assemble(coords)
    A_ord, _ = ordering.system(A_un, b_un)
    b.sync()
    d.update(b2_setup_s=time.perf_counter() - t0, ell_k=int(A_un.k),
             nnz=int(assemble.pattern.nnz))
    del coords, b_un
    d["spmv_ell"] = {}
    for label, A in (("ordered", A_ord), ("unordered", ell_to_sliced(A_un))):
        x = torch.ones(A.n_cols, dtype=f32, device=dev)
        nnz = int((unslice(A).cols < A.n_cols).sum())
        d["spmv_ell"][label], ok = b.spmv_rate(
            lambda A=A, x=x: ell_spmv_cuda.ell_spmv(A, x),
            lambda A=A, x=x: spmv_sliced(A, x), A, nnz)
        d["spmv_ell"][label]["ordering"] = (ordering.name
                                            if label == "ordered" else None)
        _bar(d, f"b2_{label}_vs_plain", ok,
             d["spmv_ell"][label]["max_rel_err_vs_plain"],
             f"<= {REL_ERR_MAX[f32]}")


def amg(b: Bench, n: int):
    d = b.detail.setdefault("amg", {})
    dev, f32 = b.device, torch.float32
    mesh, dbc = _permuted_box(n, 2)
    d["mesh"] = f"permuted (rng 2) tet {n}^3 x6 = {mesh.n_elem} elems"
    runs = {}
    for pc in ("jacobi", "amg"):
        r = b.counted(d, pc, lambda: solve_implicit(
            mesh, 1, dbc, _poisson_fn, device=dev, dtype=f32, rtol=RTOL,
            recover=False, precond=pc))
        runs[pc] = s = _solve_fields(r, mesh)
        d.update({f"{pc}_iters": s["iters"], pc: s})
        _bar(d, f"{pc}_converged", s["converged"] and s["relres"] <= RTOL
             and s["nodal_err"] <= NODAL["amg"],
             [s["relres"], s["nodal_err"]],
             f"relres <= {RTOL}, nodal <= {NODAL['amg']}")
        if pc == "amg":
            d.update(levels=r.timings.get("amg_levels"),
                     amg_setup_s=r.timings.get("amg_setup_s"),
                     precond_used=r.timings.get("precond_used"))
        del r
    d["speedup_vs_jacobi"] = (runs["jacobi"]["time_to_solution_s"]
                              / runs["amg"]["time_to_solution_s"])
    _bar(d, "amg_used", d["precond_used"] == "amg", d["precond_used"], "amg")
    _bar(d, "amg_fewer_iters", runs["amg"]["iters"] < runs["jacobi"]["iters"],
         runs["amg"]["iters"], f"< {runs['jacobi']['iters']}")
    if n in AMG_LEVELS:
        _bar(d, "levels", d["levels"] == AMG_LEVELS[n], d["levels"],
             AMG_LEVELS[n])
        _bar(d, "amg_iters", runs["amg"]["iters"] <= AMG_ITERS_MAX,
             runs["amg"]["iters"], f"<= {AMG_ITERS_MAX}")


def large_unstructured(b: Bench, n: int):
    d = b.detail.setdefault("large_unstructured", {})
    dev, f32 = b.device, torch.float32
    bars = LU_BARS.get(n)
    t_all = time.perf_counter()
    mesh, dbc = _permuted_box(n, 0)
    d.update(mesh=f"permuted tet {n}^3 x6 = {mesh.n_elem} elems",
             n_elem=int(mesh.n_elem), mesh_s=time.perf_counter() - t_all)
    _peak_reset(b)
    r = b.counted(d, "jacobi", lambda: solve_implicit(
        mesh, 1, dbc, _poisson_fn, device=dev, dtype=f32, rtol=RTOL,
        recover=False))
    s = _solve_fields(r, mesh)
    tm = r.timings
    nnz = int(tm.get("hybrid_nnz_dia", 0) + tm.get("hybrid_nnz_rem", 0))
    d.update(n_dof=int(r.u_reduced.numel()), nnz=nnz, cg_iters=s["iters"],
             cg_relres=s["relres"], nodal_err_vs_exact=s["nodal_err"],
             ms_per_iter=s["ms_per_iter"],
             cg_nnz_per_s=nnz * s["iters"] / tm["solve_s"],
             assembly_elems_per_s=mesh.n_elem / tm["assemble_s"],
             **{k: tm[k] for k in tm
                if k in ("pattern_s", "order_s", "ordering", "assemble_s",
                         "solve_s") or k.startswith("hybrid_")})
    _peak(b, d)
    d["total_s"] = time.perf_counter() - t_all
    _bar(d, "ell_path", "order_s" in tm, sorted(tm), "order_s")
    _bar(d, "cg_converged", s["converged"] and s["relres"] <= RTOL,
         s["relres"], f"<= {RTOL}")
    _bar(d, "cg_nodal_err", s["nodal_err"] <= NODAL["large_unstructured"],
         s["nodal_err"], f"<= {NODAL['large_unstructured']}")
    _bar(d, "hybrid_nnz_rem", tm.get("hybrid_nnz_rem") == 0,
         tm.get("hybrid_nnz_rem"), 0)
    _bar(d, "rows", d["n_dof"] == (n - 1) ** 3, d["n_dof"], (n - 1) ** 3)
    if bars:
        _bar(d, "nnz", nnz == bars["nnz"], nnz, bars["nnz"])
        _band(d, "cg_iters", s["iters"], bars, "iters")


def dist_spmv(b: Bench, n: int):
    d = b.detail.setdefault("dist_spmv", {})
    dev, f32 = b.device, torch.float32

    # B1's halo entry on the world-size-1 slab block (whole lattice planes)
    t0 = time.perf_counter()
    mesh, dbc = _box(n)
    sys_ = build_sharded_system(mesh, 1, dbc, 1, method="slab")
    Ke, _ = _poisson_fn(element_coords(mesh, f32, dev))
    A = assemble_matrix(Ke, build_assembly_plan(sys_.pattern, dev))
    del Ke
    A = DIAMatrix(vals=A.vals, offsets=A.offsets, n_rows=A.n_rows)
    b.sync()
    x = torch.ones(A.n_rows, dtype=f32, device=dev)
    row, ok = b.spmv_rate(
        lambda: dia_spmv_cuda.dia_spmv_halo(A, x, None, None),
        lambda: spmv_dia_halo_local(A, x, None, None), A, _dia_nnz(A),
        x=x)
    row.update(rows=A.n_rows, diagonals=len(A.offsets),
               setup_s=time.perf_counter() - t0,
               shape=f"box_tet n={n}, world size 1 (slab), halos None")
    d["b1_halo"] = row
    _bar(d, "b1_halo_vs_plain", ok, row["max_rel_err_vs_plain"],
         f"<= {REL_ERR_MAX[f32]}")
    del A, x, sys_

    # B2 on rank 1's ghost-extended block of an 8-way RCB partition
    t0 = time.perf_counter()
    S, rk = PARTS, 1
    pmesh, pdbc = _permuted_box(n, 0)
    sys_ = build_sharded_system(pmesh, 1, pdbc, S, method="rcb",
                                layout="ell")
    P, n_rows = sys_.rows_per_shard, sys_.n_rows_padded
    Ke, _ = _poisson_fn(element_coords(pmesh, f32, dev))
    A_all = assemble_ell_values(Ke, build_assembly_plan(sys_.pattern, dev))
    del Ke
    blocks = [A_all.cols[t * P:(t + 1) * P] for t in range(S)]
    plans = [reader_plan(c, t, S, n_rows) for t, c in enumerate(blocks)]
    wx = round_up(max(max(int(p.counts.max()) for p in plans), 1), 8)
    cols = [local_columns(c, plans[t], t, S, n_rows, wx)
            for t, c in enumerate(blocks)]
    vals = A_all.vals[rk * P:(rk + 1) * P]
    del A_all, blocks
    A = slice_ell(cols[rk], P + S * wx).pack(vals)
    b.sync()
    x = torch.ones(A.n_cols, dtype=f32, device=dev)
    nnz = int((unslice(A).cols < A.n_cols).sum())
    row, ok = b.spmv_rate(lambda: ell_spmv_cuda.ell_spmv(A, x),
                          lambda: spmv_sliced(A, x), A, nnz, x=x)
    shape = f"renumbered box_tet n={n}, rank {rk} of {S} (rcb)"
    row.update(rows=P, n_cols=A.n_cols, ghosts=int(plans[rk].counts.sum()),
               wx=wx, setup_s=time.perf_counter() - t0,
               shape=shape + ", ghost-extended")
    d["b2_ghost"] = row
    _bar(d, "b2_ghost_vs_plain", ok, row["max_rel_err_vs_plain"],
         f"<= {REL_ERR_MAX[f32]}")

    # the same rank's per-rank hybrid, the float32 route's operator: the
    # diagonals picked from the census of every rank, as the route picks
    # them; B1 on the dense local diagonals and the rank's own x, B2 on the
    # remainder (its ghost columns included) and the ghost-extended x
    t0 = time.perf_counter()
    host = [c.cpu().numpy() for c in cols]
    offsets = hybrid_offsets(sum(hybrid_counts(c) for c in host), S)
    d["hybrid"] = dict(diagonals=len(offsets), shape=shape)
    if offsets:
        plan = hybrid_split(host[rk], offsets, A.n_cols)
        H = hybrid_layout(plan, dev).pack(vals)
        b.sync()
        d["hybrid"].update(nnz_dia=plan.nnz_dia, nnz_rem=plan.nnz_rem,
                           k_rem=plan.k_rem, setup_s=time.perf_counter() - t0)
        x_l = x[:P]
        row, ok = b.spmv_rate(lambda: dia_spmv_cuda.dia_spmv(H.dia, x_l),
                              lambda: spmv_dia(H.dia, x_l), H.dia,
                              _dia_nnz(H.dia), x=x_l)
        row.update(rows=P, diagonals=plan.D)
        d["hybrid_b1"] = row
        _bar(d, "hybrid_b1_vs_plain", ok, row["max_rel_err_vs_plain"],
             f"<= {REL_ERR_MAX[f32]}")
        if H.rem is not None:
            row, ok = b.spmv_rate(lambda: ell_spmv_cuda.ell_spmv(H.rem, x),
                                  lambda: spmv_sliced(H.rem, x), H.rem,
                                  plan.nnz_rem, x=x)
            row.update(rows=P, n_cols=H.rem.n_cols, k_rem=plan.k_rem)
            d["hybrid_b2"] = row
            _bar(d, "hybrid_b2_vs_plain", ok, row["max_rel_err_vs_plain"],
                 f"<= {REL_ERR_MAX[f32]}")


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def _parser():
    p = argparse.ArgumentParser(
        prog="python -m pfemfort_tpu_torch.bench",
        description="the port's bench harness (seven stages, one JSON "
                    "result line last)")
    p.add_argument("n", type=int, nargs="?", default=96,
                   help="flagship box (unstructured and amg: max(n, 16))")
    p.add_argument("n_large", type=int, nargs="?", default=200,
                   help="the large stage's box (0 skips it)")
    p.add_argument("n_large_unstr", type=int, nargs="?", default=160,
                   help="the large_unstructured stage's box (0 skips it)")
    add_options(p)
    return p


def add_options(p):
    """The options the CLI's `bench` subcommand shares."""
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--detail", default=str(ROOT / "BENCH_TORCH_DETAIL.json"),
                   help="the detail file (BENCH_TORCH_PARTIAL.json is "
                        "written beside it)")
    p.add_argument("--budget-s", type=float, default=1000.0,
                   help="wall-clock budget: a stage that would start with "
                        "under 60 s left is skipped (and fails)")


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"bench --device {args.device}: "
                         "torch.cuda.is_available() is false (pass --device "
                         "cpu to run on the CPU)")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    b = Bench(device, args.budget_s, Path(args.detail))
    b.detail.update(device=str(device), card=b.card, dtype="float32",
                    budget_s=args.budget_s,
                    sizes=dict(n=args.n, n_large=args.n_large,
                               n_large_unstr=args.n_large_unstr),
                    torch=torch.__version__, cuda=torch.version.cuda)

    # warm-up outside the stages: the card's context, the kernels' loads
    t0 = time.perf_counter()
    solve_poisson(*_box(4), device=device, dtype=torch.float32)
    b.detail["warm_up_s"] = time.perf_counter() - t0

    nu = max(args.n, 16)
    plan = {"flagship": (flagship, (args.n,)),
            "partition_quality": (partition_quality, ()),
            "large": (large, (args.n_large,)),
            "unstructured": (unstructured, (nu,)),
            "amg": (amg, (nu,)),
            "large_unstructured": (large_unstructured, (args.n_large_unstr,)),
            "dist_spmv": (dist_spmv, (args.n,))}
    for name in STAGES:
        fn, fargs = plan[name]
        if fargs and fargs[0] <= 0:
            continue
        if b.remaining() < 60.0:
            b.detail[name] = {"skipped": f"budget exhausted "
                              f"({b.remaining():.0f}s left)"}
            _log(f"[{name}] skipped: {b.remaining():.0f}s of budget left")
            print(b.result_line(), flush=True)
            continue
        t0 = time.perf_counter()
        _peak_reset(b)
        try:
            with stage_guard(name, min(STAGE_CAP_S[name],
                                       b.remaining() - 15.0)):
                fn(b, *fargs)
            _check_bars(b.detail[name])
        except Exception as ex:      # recorded; the run goes on, exit 1
            _log(f"[{name}] failed: {type(ex).__name__}: {str(ex)[:300]}")
            b.detail.setdefault(name, {})["error"] = \
                f"{type(ex).__name__}: {str(ex)[:300]}"
        st = b.detail[name]
        st["stage_s"] = time.perf_counter() - t0
        if "peak_device_bytes" not in st:
            _peak(b, st)
        b.flush_partial(name)
        print(b.result_line(), flush=True)

    if b.nnz_per_s <= 0.0 and isinstance(b.detail.get("large"), dict):
        b.nnz_per_s = float(b.detail["large"].get("cg_nnz_per_s", 0.0))
        if b.nnz_per_s:
            b.detail["headline_source"] = "large.cg_nnz_per_s"
    b.detail["total_wall_s"] = time.perf_counter() - b.t0
    with open(b.detail_path, "w") as f:
        json.dump(_san(b.detail), f, indent=1)
    line = b.result_line()
    print(line, flush=True)
    return 0 if all(json.loads(line)["stages"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
