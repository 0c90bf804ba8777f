#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout around this file; it
exits non-zero (and prints no result line) without them.  It imports nothing
of JAX.  Phases, one line of output each:

  1. device   the card's name and power limit (nvidia-smi);
  2. build    nvcc builds the kernel of the path (csrc/dia_spmv.cu);
  3. kernel   the kernel against the plain PyTorch SpMV on the card, in
              float32 and float64, on the flagship system (box_tet n=96,
              857,375 rows, 15 diagonals) and on a ragged system; then a
              small float64 solve on the card against the same solve on
              the CPU;
  4. solve    solve_poisson on box_tet n=96 in float32 to rtol 1e-6, with
              the kernel's launch count reset just before and read just
              after: converged, relres <= 1e-6, 271 +- 10 iterations, nodal
              error <= 2e-4 against u = x^2+y^2+z^2, launches >= iterations;
  5. timing   kernel and plain SpMV time at the flagship shape, the GB/s
              they imply, and the solve's assembly and CG seconds.

Then one JSON line describing the kernels, and the result line
{"ok": true, "device": {...}} last.  Any failed check raises.
"""

import json
import subprocess
import time

import numpy as np
import torch

from pfemfort_tpu_torch import build_dofmap, generate, solve_poisson
from pfemfort_tpu_torch.drivers.common import build_reduced_assembler
from pfemfort_tpu_torch.elements.geometry import to_element_minor
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
from pfemfort_tpu_torch.sparse import dia_spmv_cuda
from pfemfort_tpu_torch.sparse.dia import DIAMatrix, spmv_dia

N_FLAGSHIP = 96
ITERS_BAR, ITERS_SLACK = 271, 10     # f32 Jacobi-CG to rtol 1e-6 (JAX package)
NODAL_ERR_MAX = 2e-4
REL_ERR_MAX = {torch.float32: 1e-5, torch.float64: 1e-12}
# Data-sheet HBM peaks in GB/s; an unknown card is measured against the SXM
# part's.
PEAK_GBPS = {"H100 PCIe": 2000.0, "H100 NVL": 3900.0, "H100": 3350.0}


def _phase(name, **fields):
    print(json.dumps(dict(phase=name, **fields)), flush=True)


def _check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _flagship_system(device, dtype):
    n = N_FLAGSHIP
    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    dofmap = build_dofmap(mesh, 1, dbc, with_elem=False)
    assemble = build_reduced_assembler(
        mesh, 1, dofmap,
        lambda c: poisson_element_matrices(c, "tetra4", source=-6.0),
        dtype, device)
    coords = torch.as_tensor(to_element_minor(mesh.elem_coords()),
                             dtype=dtype, device=device)
    A, _ = assemble(coords)
    return A


def _ragged_system(device, dtype, rng):
    n = 300_007
    offsets = (-(n + 5), -4097, -1, 0, 3, 12_345, n + 2)
    vals = torch.as_tensor(rng.standard_normal((len(offsets), n)),
                           dtype=dtype, device=device)
    return DIAMatrix(vals=vals, offsets=offsets, n_rows=n)


def _compare(A, x):
    """Kernel vs plain on the card: (max abs err, max rel err)."""
    offsets = torch.tensor(A.offsets, dtype=torch.int32, device=x.device)
    y = dia_spmv_cuda.dia_spmv(A, x, offsets)
    y_ref = spmv_dia(A, x)
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

    # 2. build
    t0 = time.perf_counter()
    dia_spmv_cuda.kernel.lib()
    _phase("build", kernel="dia_spmv",
           library=str(dia_spmv_cuda.library_path().name),
           seconds=time.perf_counter() - t0)

    # 3. kernel vs plain
    A32 = _flagship_system(dev, torch.float32)
    _check(A32.n_rows == 857_375 and len(A32.offsets) == 15,
           f"flagship DIA is {A32.n_rows} rows x {len(A32.offsets)} diagonals")
    cases = {"flagship": A32, "ragged": _ragged_system(dev, torch.float32, rng)}
    errs = {}
    for label, A in cases.items():
        x64 = rng.standard_normal(A.n_rows)
        for dtype in (torch.float32, torch.float64):
            Ad = DIAMatrix(vals=A.vals.to(dtype), offsets=A.offsets,
                           n_rows=A.n_rows, lattice=A.lattice)
            abs_err, rel_err = _compare(
                Ad, torch.as_tensor(x64, dtype=dtype, device=dev))
            errs[(label, dtype)] = abs_err
            _phase("kernel", case=label, dtype=str(dtype), rows=A.n_rows,
                   diagonals=len(A.offsets), max_abs_err=abs_err,
                   max_rel_err=rel_err, bound=REL_ERR_MAX[dtype])
            _check(rel_err <= REL_ERR_MAX[dtype],
                   f"{label} {dtype}: rel err {rel_err} > "
                   f"{REL_ERR_MAX[dtype]}")
    m8, d8 = generate.box_tet(0, 1, 8, 0, 1, 8, 0, 1, 8)
    small = [solve_poisson(m8, d8, device=d, dtype=torch.float64, rtol=1e-10)
             for d in ("cpu", dev)]
    u_diff = float(np.abs(small[0].u_full - small[1].u_full).max())
    _phase("kernel", case="box_tet n=8 f64 solve, cuda vs cpu",
           iters=[r.stats.iters for r in small], max_abs_u_diff=u_diff)
    _check(small[0].stats.iters == small[1].stats.iters and u_diff <= 1e-10,
           "small f64 solve on the card differs from the CPU solve")

    # 4. the main path, counted
    n = N_FLAGSHIP
    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    dia_spmv_cuda.kernel.launches = 0
    res = solve_poisson(mesh, dbc, device=dev, dtype=torch.float32, rtol=1e-6)
    launches = dia_spmv_cuda.kernel.launches
    u_exact = (mesh.coords ** 2).sum(axis=1)
    nodal_err = float(np.abs(res.u_full - u_exact).max())
    st = res.stats
    _phase("solve", n=n, elements=mesh.n_elem, dofs=int(res.u_reduced.numel()),
           iters=st.iters, relres=st.relres, converged=st.converged,
           nodal_err=nodal_err, launches=launches,
           finite=bool(np.isfinite(res.u_full).all()), **res.timings)
    _check(st.converged and st.relres <= 1e-6, f"solve: {st}")
    _check(abs(st.iters - ITERS_BAR) <= ITERS_SLACK,
           f"{st.iters} iterations, not {ITERS_BAR} +- {ITERS_SLACK}")
    _check(bool(np.isfinite(res.u_full).all()) and res.u_full.shape
           == (mesh.n_node,), "solution shape or values")
    _check(nodal_err <= NODAL_ERR_MAX, f"nodal error {nodal_err}")
    _check(launches >= st.iters, f"{launches} launches < {st.iters} iters")

    # 5. timing at the flagship shape (plain, kernel, kernel, plain)
    x = torch.ones(A32.n_rows, dtype=torch.float32, device=dev)
    offsets = torch.tensor(A32.offsets, dtype=torch.int32, device=dev)
    run = {"plain": lambda: spmv_dia(A32, x),
           "kernel": lambda: dia_spmv_cuda.dia_spmv(A32, x, offsets)}
    for fn in run.values():
        _time_ms(fn, 10)
    times = {k: [] for k in run}
    for k in ("plain", "kernel", "kernel", "plain"):
        times[k].append(_time_ms(run[k], 200))
    ms = {k: float(np.mean(v)) for k, v in times.items()}
    nbytes = (len(A32.offsets) + 2) * A32.n_rows * 4
    peak = next((v for k, v in PEAK_GBPS.items() if k in kind),
                PEAK_GBPS["H100"])
    gbps = {k: nbytes / (v * 1e-3) / 1e9 for k, v in ms.items()}
    _phase("timing", card=smi, spmv_bytes=nbytes, kernel_ms=ms["kernel"],
           plain_ms=ms["plain"], kernel_ms_runs=times["kernel"],
           plain_ms_runs=times["plain"], kernel_gbps=gbps["kernel"],
           plain_gbps=gbps["plain"], peak_gbps=peak,
           kernel_peak_share=gbps["kernel"] / peak,
           assemble_s=res.timings["assemble_s"],
           cg_s=res.timings["solve_s"], cg_iters=st.iters,
           cg_ms_per_iter=1e3 * res.timings["solve_s"] / max(st.iters, 1))

    print(json.dumps({"kernels": [{
        "name": "dia_spmv", "route": "cuda",
        "source": "pfemfort_tpu_torch/csrc/dia_spmv.cu",
        "replaces": "pfemfort_tpu/sparse/pallas_spmv.py:48",
        "launches": launches,
        "max_abs_err": errs[("flagship", torch.float32)],
        "ms": ms["kernel"], "plain_ms": ms["plain"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
