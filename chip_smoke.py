#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout around this file; it
exits non-zero (and prints no result line) without them.  It imports nothing
of JAX.  Phases, one JSON line each:

  1. device          the card's name and power limit (nvidia-smi);
  2. build           nvcc builds both kernels, one process per source,
                     started together (csrc/dia_spmv.cu, csrc/ell_spmv.cu);
  3. kernel          each kernel against its plain PyTorch SpMV on the card,
                     in float32 (relative error <= 1e-5) and float64
                     (<= 1e-12).  DIA: the box_tet n=96 lattice system and a
                     ragged one.  ELL: box_tet n=96 with its nodes randomly
                     renumbered (857,375 rows, K = 16) in the solve's row
                     order and unordered, and a ragged rectangular block with
                     both sentinels.  Then small float64 solves on the card
                     against the same solves on the CPU (box_tet n=8 on the
                     DIA path, scrambled Delaunay n=32 on the ELL path);
  4. solve           solve_poisson on box_tet n=96, float32, rtol 1e-6
                     (the lattice path, kernel B1): converged, relres <=
                     1e-6, 271 +- 10 iterations, nodal error <= 2e-4 against
                     u = x^2+y^2+z^2, B1 launches >= iterations;
  5. solve_ell       solve_implicit on the renumbered n=96 mesh with
                     recover=False (the ELL path, kernel B2): the same bars,
                     B2 launches >= iterations, B1 launches = 0; and the ELL
                     assembly repeated bit for bit;
  6. solve_recovered solve_poisson on box_tet n=48 with its nodes renumbered:
                     the structure is recovered, B1 launches >= iterations,
                     B2 launches = 0, iterations = the lattice solve's +- 1;
  7. timing          kernel and plain SpMV times (plain, kernel, kernel,
                     plain) of B1 on the n=96 lattice system and of B2 on the
                     same matrix in the solve's row order, in lattice order
                     and unordered, the GB/s they imply, and each solve's
                     seconds by stage.

Every launch count is set to 0 just before its path is driven and read just
after.  Then one JSON line describing the kernels, and the result line
{"ok": true, "device": {...}} last.  Any failed check raises.
"""

import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pfemfort_tpu_torch import Mesh, build_dofmap, generate, solve_poisson
from pfemfort_tpu_torch.drivers.common import build_ell_ordering, \
    build_reduced_assembler, solve_implicit
from pfemfort_tpu_torch.elements.geometry import to_element_minor
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
from pfemfort_tpu_torch.sparse import dia_spmv_cuda, ell_spmv_cuda
from pfemfort_tpu_torch.sparse.dia import DIAMatrix, spmv_dia
from pfemfort_tpu_torch.sparse.formats import ELLMatrix
from pfemfort_tpu_torch.sparse.ordering import coord_lex_order, \
    permuted_sorted_cols
from pfemfort_tpu_torch.sparse.spmv import spmv_ell

N_FLAGSHIP = 96
N_RECOVERED = 48
N_DELAUNAY = 32
ITERS_BAR, ITERS_SLACK = 271, 10     # f32 Jacobi-CG to rtol 1e-6 (JAX package)
NODAL_ERR_MAX = 2e-4
REL_ERR_MAX = {torch.float32: 1e-5, torch.float64: 1e-12}
KERNELS = {"dia_spmv": dia_spmv_cuda.kernel, "ell_spmv": ell_spmv_cuda.kernel}
# Data-sheet HBM peaks in GB/s; an unknown card is measured against the SXM
# part's.
PEAK_GBPS = {"H100 PCIe": 2000.0, "H100 NVL": 3900.0, "H100": 3350.0}


def _phase(name, **fields):
    print(json.dumps(dict(phase=name, **fields)), flush=True)


def _check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _poisson_fn(coords_em):
    return poisson_element_matrices(coords_em, "tetra4", source=-6.0)


def _reset_launches():
    for k in KERNELS.values():
        k.launches = 0


def _launches():
    return {name: k.launches for name, k in KERNELS.items()}


def _flagship_system(device, dtype):
    n = N_FLAGSHIP
    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    dofmap = build_dofmap(mesh, 1, dbc, with_elem=False)
    assemble = build_reduced_assembler(mesh, 1, dofmap, _poisson_fn, dtype,
                                       device)
    coords = torch.as_tensor(to_element_minor(mesh.elem_coords()),
                             dtype=dtype, device=device)
    A, _ = assemble(coords)
    return A


def _permuted_box(n, seed=0):
    """box_tet n with its nodes randomly renumbered (no structure left)."""
    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    perm = np.random.default_rng(seed).permutation(mesh.n_node)
    mesh = mesh.renumbered(perm.astype(np.int64))
    dbc = dbc.copy()
    dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    return mesh, dbc


def _scrambled_delaunay(n, seed=0):
    """Delaunay tets of a jittered (n+1)^3 lattice of the unit cube, nodes
    randomly renumbered; Dirichlet u = x^2+y^2+z^2 on the hull."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    g = np.linspace(0, 1, n + 1)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    pts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    interior = ((pts > 1e-9) & (pts < 1 - 1e-9)).all(axis=1)
    pts[interior] += rng.uniform(-0.25, 0.25, (int(interior.sum()), 3)) / n
    tri = Delaunay(pts)
    conn = tri.simplices.astype(np.int64)
    a, b, c, d = (pts[conn[:, i]] for i in range(4))
    vol6 = np.einsum("ij,ij->i", np.cross(b - a, c - a), d - a)
    conn[vol6 < 0] = conn[vol6 < 0][:, [0, 2, 1, 3]]
    conn = conn[np.abs(vol6) > 1e-12]
    hull = np.unique(tri.convex_hull)
    dbc = np.stack([hull, np.zeros(len(hull)), (pts[hull] ** 2).sum(1)], 1)
    perm = rng.permutation(len(pts))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(pts))
    dbc[:, 0] = perm[hull]
    return Mesh("tetra4", pts[inv], perm[conn]), dbc


def _flagship_ell(device, dtype):
    """The renumbered n=96 system as the ELL path builds it: the unordered
    assembly, its row ordering, the host set-up seconds by step, and the
    geometric (lex) row order, which is the lattice's own numbering."""
    secs = {}
    t0 = time.perf_counter()
    mesh, dbc = _permuted_box(N_FLAGSHIP)
    dofmap = build_dofmap(mesh, 1, dbc)
    secs["mesh_and_dofmap_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    assemble = build_reduced_assembler(mesh, 1, dofmap, _poisson_fn, dtype,
                                       device)
    torch.cuda.synchronize()
    secs["pattern_and_plan_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    coords = torch.as_tensor(to_element_minor(mesh.elem_coords()),
                             dtype=dtype, device=device)
    torch.cuda.synchronize()
    secs["coords_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ordering = build_ell_ordering(assemble.pattern,
                                  mesh.coords[dofmap.assy_for_soln],
                                  dofmap.assy_for_soln % 1, device)
    torch.cuda.synchronize()
    secs["ordering_s"] = time.perf_counter() - t0
    lex = coord_lex_order(mesh.coords[dofmap.assy_for_soln])
    return assemble, coords, ordering, secs, lex


def _ragged_ell(device, rng):
    """K = 7, a rectangular block (n_cols = n_rows + 10,007), padded slots
    holding either sentinel (n_cols, 2 * n_rows + 128)."""
    n_rows, k = 300_007, 7
    n_cols = n_rows + 10_007
    cols = rng.integers(0, n_cols, (n_rows, k))
    pad = rng.random((n_rows, k)) < 0.3
    cols = np.where(pad, np.where(rng.random((n_rows, k)) < 0.5, n_cols,
                                  2 * n_rows + 128), cols)
    vals = np.where(pad, 0.0, rng.standard_normal((n_rows, k)))
    return ELLMatrix(cols=torch.as_tensor(cols, dtype=torch.int32,
                                          device=device),
                     vals=torch.as_tensor(vals, dtype=torch.float32,
                                          device=device),
                     n_cols=n_cols)


def _ragged_dia(device, dtype, rng):
    n = 300_007
    offsets = (-(n + 5), -4097, -1, 0, 3, 12_345, n + 2)
    vals = torch.as_tensor(rng.standard_normal((len(offsets), n)),
                           dtype=dtype, device=device)
    return DIAMatrix(vals=vals, offsets=offsets, n_rows=n)


def _errors(y, y_ref):
    torch.cuda.synchronize()
    err = float((y - y_ref).abs().max())
    return err, err / float(y_ref.abs().max())


def _time_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _timed_pairs(plain, kernel, reps=200):
    """Mean ms of (plain, kernel, kernel, plain) runs, and each run."""
    run = {"plain": plain, "kernel": kernel}
    for fn in run.values():
        _time_ms(fn, 10)
    times = {k: [] for k in run}
    for k in ("plain", "kernel", "kernel", "plain"):
        times[k].append(_time_ms(run[k], reps))
    return {k: float(np.mean(v)) for k, v in times.items()}, times


def _check_solve(label, res, u_exact):
    st = res.stats
    nodal_err = float(np.abs(res.u_full - u_exact).max())
    _check(st.converged and st.relres <= 1e-6, f"{label}: {st}")
    _check(abs(st.iters - ITERS_BAR) <= ITERS_SLACK,
           f"{label}: {st.iters} iterations, not {ITERS_BAR} +- "
           f"{ITERS_SLACK}")
    _check(bool(np.isfinite(res.u_full).all())
           and res.u_full.shape == u_exact.shape, f"{label}: solution")
    _check(nodal_err <= NODAL_ERR_MAX, f"{label}: nodal error {nodal_err}")
    return nodal_err


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    _phase("device", kind=kind, count=torch.cuda.device_count(),
           nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build: one nvcc per source, started together
    def build(kern):
        t0 = time.perf_counter()
        kern.build()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        builds = {name: pool.submit(build, k) for name, k in KERNELS.items()}
        for name, fut in builds.items():
            seconds = fut.result()
            KERNELS[name].lib()
            _phase("build", kernel=name,
                   library=KERNELS[name].library_path().name,
                   seconds=seconds)

    # 3. kernels vs plain
    errs = {}
    A32 = _flagship_system(dev, torch.float32)
    _check(A32.n_rows == 857_375 and len(A32.offsets) == 15,
           f"flagship DIA is {A32.n_rows} rows x {len(A32.offsets)} diagonals")
    for label, A in {"flagship": A32,
                     "ragged": _ragged_dia(dev, torch.float32, rng)}.items():
        x64 = rng.standard_normal(A.n_rows)
        offsets = torch.tensor(A.offsets, dtype=torch.int32, device=dev)
        for dtype in (torch.float32, torch.float64):
            Ad = DIAMatrix(vals=A.vals.to(dtype), offsets=A.offsets,
                           n_rows=A.n_rows, lattice=A.lattice)
            x = torch.as_tensor(x64, dtype=dtype, device=dev)
            abs_err, rel_err = _errors(dia_spmv_cuda.dia_spmv(Ad, x, offsets),
                                       spmv_dia(Ad, x))
            errs[("dia_spmv", label, dtype)] = abs_err
            _phase("kernel", kernel="dia_spmv", case=label, dtype=str(dtype),
                   rows=A.n_rows, diagonals=len(A.offsets),
                   max_abs_err=abs_err, max_rel_err=rel_err,
                   bound=REL_ERR_MAX[dtype])
            _check(rel_err <= REL_ERR_MAX[dtype],
                   f"dia_spmv {label} {dtype}: rel err {rel_err}")

    assemble, coords, ordering, setup_s, lex = _flagship_ell(dev,
                                                              torch.float32)
    A_un, b_un = assemble(coords)
    A_ord, b_ord = ordering.system(A_un, b_un)
    _check(A_un.n_rows == 857_375 and A_un.k == 16,
           f"renumbered n=96 ELL is {A_un.n_rows} rows x K = {A_un.k}")
    _phase("kernel", kernel="ell_spmv", case="set-up of the n=96 ELL system",
           ordering=ordering.name, nnz=assemble.pattern.nnz, **setup_s)
    ell_cases = {"ordered": A_ord, "unordered": A_un,
                 "ragged": _ragged_ell(dev, rng)}
    for label, A in ell_cases.items():
        x64 = rng.standard_normal(A.n_cols)
        for dtype in (torch.float32, torch.float64):
            Ad = ELLMatrix(cols=A.cols, vals=A.vals.to(dtype), n_cols=A.n_cols)
            x = torch.as_tensor(x64, dtype=dtype, device=dev)
            abs_err, rel_err = _errors(ell_spmv_cuda.ell_spmv(Ad, x),
                                       spmv_ell(Ad, x))
            errs[("ell_spmv", label, dtype)] = abs_err
            _phase("kernel", kernel="ell_spmv", case=label, dtype=str(dtype),
                   rows=A.n_rows, n_cols=A.n_cols, k=A.k,
                   max_abs_err=abs_err, max_rel_err=rel_err,
                   bound=REL_ERR_MAX[dtype])
            _check(rel_err <= REL_ERR_MAX[dtype],
                   f"ell_spmv {label} {dtype}: rel err {rel_err}")

    m8, d8 = generate.box_tet(0, 1, 8, 0, 1, 8, 0, 1, 8)
    small = [solve_poisson(m8, d8, device=d, dtype=torch.float64, rtol=1e-10)
             for d in ("cpu", dev)]
    u_diff = float(np.abs(small[0].u_full - small[1].u_full).max())
    _phase("kernel", kernel="dia_spmv", case="box_tet n=8 f64 solve, card "
           "vs cpu", iters=[r.stats.iters for r in small],
           max_abs_u_diff=u_diff)
    _check(small[0].stats.iters == small[1].stats.iters and u_diff <= 1e-10,
           "small f64 DIA solve on the card differs from the CPU solve")
    md, dd = _scrambled_delaunay(N_DELAUNAY)
    # The card sums in another order than the CPU.  On this mesh CG's count
    # is sensitive to that: relative perturbations of 1e-15 to 1e-14 in A
    # and b spread it over 2 to 6 iterations at every rtol from 1e-6 to
    # 1e-12 (PERF.md).  The check holds because both sides are
    # deterministic; at rtol 1e-10 the two counts came out one apart.
    dl = [solve_poisson(md, dd, device=d, dtype=torch.float64, rtol=1e-10)
          for d in ("cpu", dev)]
    u_diff = float(np.abs(dl[0].u_full - dl[1].u_full).max())
    _phase("kernel", kernel="ell_spmv", case=f"scrambled Delaunay "
           f"n={N_DELAUNAY} f64 solve, card vs cpu", nodes=md.n_node,
           elements=md.n_elem, iters=[r.stats.iters for r in dl],
           max_abs_u_diff=u_diff, timings_card=dl[1].timings)
    _check(all("order_s" in r.timings for r in dl),
           "the Delaunay solve did not take the ELL path")
    _check(abs(dl[0].stats.iters - dl[1].stats.iters) <= 1
           and u_diff <= 1e-10,
           "Delaunay f64 ELL solve on the card differs from the CPU solve")

    # 4. the lattice path, counted
    n = N_FLAGSHIP
    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    u_exact = (mesh.coords ** 2).sum(axis=1)
    _reset_launches()
    res = solve_poisson(mesh, dbc, device=dev, dtype=torch.float32, rtol=1e-6)
    launches_dia = _launches()
    nodal_err = _check_solve("solve", res, u_exact)
    st = res.stats
    _phase("solve", n=n, elements=mesh.n_elem, dofs=int(res.u_reduced.numel()),
           iters=st.iters, relres=st.relres, converged=st.converged,
           nodal_err=nodal_err, launches=launches_dia,
           finite=bool(np.isfinite(res.u_full).all()), **res.timings)
    _check(launches_dia["dia_spmv"] >= st.iters and
           launches_dia["ell_spmv"] == 0,
           f"lattice solve launches {launches_dia} vs {st.iters} iters")
    solve_dia = res

    # 5. the ELL path, counted
    pmesh, pdbc = _permuted_box(N_FLAGSHIP)
    _reset_launches()
    res = solve_implicit(pmesh, 1, pdbc, _poisson_fn, device=dev,
                         dtype=torch.float32, rtol=1e-6, recover=False)
    launches_ell = _launches()
    nodal_err = _check_solve("solve_ell", res, (pmesh.coords ** 2).sum(1))
    st = res.stats
    (A1, b1), (A2, b2) = (ordering.system(*assemble(coords))
                          for _ in range(2))
    repeat = (torch.equal(A1.vals, A2.vals) and torch.equal(b1, b2)
              and torch.equal(A1.vals, A_ord.vals) and torch.equal(b1, b_ord))
    _phase("solve_ell", n=n, elements=pmesh.n_elem,
           dofs=int(res.u_reduced.numel()), iters=st.iters,
           relres=st.relres, converged=st.converged, nodal_err=nodal_err,
           launches=launches_ell, assembly_bit_identical=repeat,
           **res.timings)
    _check("order_s" in res.timings, "solve_ell did not take the ELL path")
    _check(launches_ell["ell_spmv"] >= st.iters and
           launches_ell["dia_spmv"] == 0,
           f"ELL solve launches {launches_ell} vs {st.iters} iters")
    _check(repeat, "ELL assembly on the card is not bit-for-bit repeatable")
    solve_ell = res

    # 6. the recovered-structure path, counted
    nr = N_RECOVERED
    lm, ld = generate.box_tet(0, 1, nr, 0, 1, nr, 0, 1, nr)
    lattice = solve_poisson(lm, ld, device=dev, dtype=torch.float32,
                            rtol=1e-6)
    rmesh, rdbc = _permuted_box(nr)
    _reset_launches()
    res = solve_poisson(rmesh, rdbc, device=dev, dtype=torch.float32,
                        rtol=1e-6)
    launches_rec = _launches()
    st = res.stats
    nodal_err = float(np.abs(res.u_full - (rmesh.coords ** 2).sum(1)).max())
    _phase("solve_recovered", n=nr, iters=st.iters, relres=st.relres,
           converged=st.converged, lattice_iters=lattice.stats.iters,
           nodal_err=nodal_err, launches=launches_rec, **res.timings)
    _check(res.timings.get("structure_recovered") is True,
           "the renumbered n=48 mesh was not recovered")
    _check(st.converged and st.relres <= 1e-6, f"solve_recovered: {st}")
    _check(abs(st.iters - lattice.stats.iters) <= 1,
           f"recovered {st.iters} vs lattice {lattice.stats.iters} iters")
    _check(launches_rec["dia_spmv"] >= st.iters and
           launches_rec["ell_spmv"] == 0,
           f"recovered solve launches {launches_rec} vs {st.iters} iters")
    _check(nodal_err <= NODAL_ERR_MAX, f"recovered nodal error {nodal_err}")

    # 7. timing on the n=96 matrix: B1 in lattice order; B2 in the solve's
    # row order, in lattice order (lex, the numbering B1 runs in) and
    # unordered
    peak = next((v for k, v in PEAK_GBPS.items() if k in kind),
                PEAK_GBPS["H100"])
    N = A32.n_rows
    x = torch.ones(N, dtype=torch.float32, device=dev)
    offsets = torch.tensor(A32.offsets, dtype=torch.int32, device=dev)
    ms = {}
    runs = {}
    ms["dia"], runs["dia"] = _timed_pairs(
        lambda: spmv_dia(A32, x),
        lambda: dia_spmv_cuda.dia_spmv(A32, x, offsets))
    cols, src, _ = permuted_sorted_cols(assemble.pattern.ell_cols, N, lex, N)
    A_lex = ELLMatrix(
        cols=torch.as_tensor(cols.astype(np.int32), device=dev),
        vals=A_un.vals.reshape(-1)[torch.as_tensor(src.reshape(-1),
                                                   device=dev)
                                   ].reshape(A_un.vals.shape),
        n_cols=N)
    for label, A in (("ell_ordered", A_ord), ("ell_lex", A_lex),
                     ("ell_unordered", A_un)):
        ms[label], runs[label] = _timed_pairs(
            lambda A=A: spmv_ell(A, x),
            lambda A=A: ell_spmv_cuda.ell_spmv(A, x))
    nbytes = {"dia": (len(A32.offsets) + 2) * N * 4,
              "ell_ordered": (2 * A_ord.k * N + 2 * N) * 4,
              "ell_lex": (2 * A_lex.k * N + 2 * N) * 4,
              "ell_unordered": (2 * A_un.k * N + 2 * N) * 4}
    for label in ms:
        gbps = {k: nbytes[label] / (v * 1e-3) / 1e9
                for k, v in ms[label].items()}
        _phase("timing", matrix=label, card=smi, spmv_bytes=nbytes[label],
               kernel_ms=ms[label]["kernel"], plain_ms=ms[label]["plain"],
               kernel_ms_runs=runs[label]["kernel"],
               plain_ms_runs=runs[label]["plain"],
               kernel_gbps=gbps["kernel"], plain_gbps=gbps["plain"],
               peak_gbps=peak, kernel_peak_share=gbps["kernel"] / peak)
    _phase("timing", matrix="b2_over_b1",
           ordering=ordering.name,
           ordered=ms["ell_ordered"]["kernel"] / ms["dia"]["kernel"],
           lex=ms["ell_lex"]["kernel"] / ms["dia"]["kernel"],
           unordered=ms["ell_unordered"]["kernel"] / ms["dia"]["kernel"])
    for label, r in (("solve", solve_dia), ("solve_ell", solve_ell)):
        _phase("timing", stages=label, card=smi, cg_iters=r.stats.iters,
               cg_ms_per_iter=1e3 * r.timings["solve_s"]
               / max(r.stats.iters, 1), **r.timings)

    print(json.dumps({"kernels": [
        {"name": "dia_spmv", "route": "cuda",
         "source": "pfemfort_tpu_torch/csrc/dia_spmv.cu",
         "replaces": "pfemfort_tpu/sparse/pallas_spmv.py:48",
         "launches": launches_dia["dia_spmv"],
         "max_abs_err": errs[("dia_spmv", "flagship", torch.float32)],
         "ms": ms["dia"]["kernel"], "plain_ms": ms["dia"]["plain"]},
        {"name": "ell_spmv", "route": "cuda",
         "source": "pfemfort_tpu_torch/csrc/ell_spmv.cu",
         "replaces": "pfemfort_tpu/sparse/slotgather.py:403",
         "launches": launches_ell["ell_spmv"],
         "max_abs_err": errs[("ell_spmv", "ordered", torch.float32)],
         "ms": ms["ell_ordered"]["kernel"],
         "plain_ms": ms["ell_ordered"]["plain"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
