#!/usr/bin/env python3
"""Kernel B1 (csrc/dia_spmv.cu) step by step, on one NVIDIA GPU.

    python3 dia_spmv_bench.py [--parent DIR] [--explore] [--out FILE]

Times, at every B1 and halo-entry shape that chip_smoke.py times, the
device time of one product (100 products queued behind a sleep kernel,
CUDA events; in turns, then in reverse) of:

  parent   with --parent DIR: the kernel of an earlier checkout (its
           pfemfort_tpu_torch/csrc/dia_spmv.cu, whose entries took the
           offsets as an int32 device array: the single-device entry for
           a B1 shape, the halo entry for a halo shape), built here with
           the kernels' nvcc flags;
  s1-s5    the design steps of csrc/dia_spmv.cu, each adding one to the
           one before: one body for both entries (one read rule), the
           test-free interior blocks, the offsets in the launch
           parameters, batches of 8 loads, streaming value loads;
  kernel   this checkout's kernel through sparse/dia_spmv_cuda.py;
  cusparse torch.sparse_csr_tensor(...) @ x on the same nonzeros (the
           concatenated [left | x | right] for a block with halos).

The steps are instantiations of one template (STEPS_SOURCE); --explore
adds the alternatives tried for them (the three-way read rule, batches of
4 and 16, an unbatched edge loop, nc.L1::no_allocate loads, register
caps, R = 2 and 4 rows a thread).  Each variant's y is compared with
the kernel's bit for bit; the parent and the steps must match it (the
same sum order, fused the same way).  It prints the card's name and
power limit, nvcc -Xptxas -v for each source, one JSON line per shape,
and writes them all to --out, with the kernel's and the parent's SASS
(cuobjdump -sass) beside it.  Needs one CUDA card and nvcc;
imports nothing of JAX.
"""

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from pfemfort_tpu_torch import build_dofmap, cuda_build, generate
from pfemfort_tpu_torch.assembly import structured
from pfemfort_tpu_torch.assembly.fullsystem import zero_dirichlet_rows
from pfemfort_tpu_torch.drivers.common import build_ell_ordering, \
    build_reduced_assembler
from pfemfort_tpu_torch.elements.elasticity import dmat_3d, \
    dmat_plane_stress
from pfemfort_tpu_torch.elements.geometry import to_element_minor
from pfemfort_tpu_torch.parallel.halo import halo_width
from pfemfort_tpu_torch.solve.multigrid import build_gmg
from pfemfort_tpu_torch.sparse import dia_spmv_cuda as b1
from pfemfort_tpu_torch.sparse.dia import DIAMatrix, decompose_offsets

ROOT = Path(__file__).resolve().parent
BUILD = ROOT / "build" / "dia_spmv_bench"
REPS = 100

STEPS_SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>
constexpr int kThreads = 256;
struct LaunchPlan {
  int64_t n, grid, interior_begin, interior_end;
  int32_t n_diag, offsets[128];
};
namespace {
template <int L, typename T>
__device__ __forceinline__ T vload(const T* p) {
  if constexpr (L == 0) {
    return __ldg(p);
  } else if constexpr (L == 1) {
    return __ldcs(p);
  } else {
    T v;
    if constexpr (sizeof(T) == 4)
      asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
    else
      asm("ld.global.nc.L1::no_allocate.f64 %0, [%1];" : "=d"(v) : "l"(p));
    return v;
  }
}
// U <= 1: a plain loop the compiler unrolls as it likes; U > 1: batches
// of U diagonals, each issuing all its loads before its multiply-adds, the
// last batch masked past n_diag
template <int U, int L, typename T, typename Off, typename Read>
__device__ __forceinline__ T row_sum(const T* v, int64_t n, int n_diag,
                                     Off off, Read read) {
  T acc = T(0);
  if constexpr (U > 1) {
    for (int d = 0; d < n_diag; d += U, v += U * n) {
      T vv[U > 1 ? U : 1], xx[U > 1 ? U : 1];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (d + u < n_diag) {
          vv[u] = vload<L>(v + u * n);
          xx[u] = read(off(d + u));
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (d + u < n_diag) acc += vv[u] * xx[u];
    }
  } else {
    for (int d = 0; d < n_diag; ++d, v += n)
      acc += vload<L>(v) * read(off(d));
  }
  return acc;
}
// R rows a thread (strided by the block size); Ui, Ue: the interior and
// the edge blocks' loops (row_sum); kSplit: test-free interior blocks;
// kParam: offsets from the launch parameters, else from device memory; L:
// value load (0 nc, 1 cs, 2 nc.L1::no_allocate); kRule: the read rule
// outside the interior, 0 three-way branches, 1 a selected base and one
// predicated load
template <typename T, int R, int Ui, int Ue, bool kSplit, bool kParam,
          int L, int kRule>
__device__ __forceinline__ void body(
    const T* __restrict__ vals, const int* __restrict__ doffs,
    const LaunchPlan& p, int64_t w, const T* __restrict__ left,
    const T* __restrict__ x, const T* __restrict__ right,
    T* __restrict__ y) {
  const int64_t n = p.n;
  const int64_t row0 =
      static_cast<int64_t>(blockIdx.x) * (R * kThreads) + threadIdx.x;
  auto off = [&](int d) -> int64_t {
    if constexpr (kParam) return p.offsets[d]; else return __ldg(doffs + d);
  };
  const int64_t jlo = left != nullptr ? -w : 0;
  const int64_t jhi = right != nullptr ? n + w : n;
  const auto lbase = reinterpret_cast<uintptr_t>(left) + w * sizeof(T);
  const auto xbase = reinterpret_cast<uintptr_t>(x);
  const auto rbase = reinterpret_cast<uintptr_t>(right) - n * sizeof(T);
  auto rule = [&](int64_t j) -> T {
    if constexpr (kRule == 0) {
      if (j < 0) return (left != nullptr && j >= -w) ? __ldg(left + (w + j)) : T(0);
      if (j >= n) return (right != nullptr && j < n + w) ? __ldg(right + (j - n)) : T(0);
      return __ldg(x + j);
    } else {
      const uintptr_t base = j < 0 ? lbase : (j < n ? xbase : rbase);
      return (j >= jlo && j < jhi)
                 ? __ldg(reinterpret_cast<const T*>(base + j * sizeof(T)))
                 : T(0);
    }
  };
  const bool interior = kSplit && blockIdx.x >= p.interior_begin &&
                        blockIdx.x < p.interior_end;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t i = row0 + r * kThreads;
    if (interior)
      y[i] = row_sum<Ui, L>(vals + i, n, p.n_diag, off,
                            [&](int64_t o) { return __ldg(x + (i + o)); });
    else if (i < n)
      y[i] = row_sum<Ue, L>(vals + i, n, p.n_diag, off,
                           [&](int64_t o) { return rule(i + o); });
  }
}
// as csrc/dia_spmv.cu, or with MB blocks resident on an SM at least
// (a cap on the registers)
template <typename T, int R, int Ui, int Ue, bool kSplit, bool kParam,
          int L, int kRule>
__global__ void __launch_bounds__(kThreads)
step(const T* __restrict__ vals, const int* __restrict__ doffs,
     const __grid_constant__ LaunchPlan p, int64_t w,
     const T* __restrict__ left, const T* __restrict__ x,
     const T* __restrict__ right, T* __restrict__ y) {
  body<T, R, Ui, Ue, kSplit, kParam, L, kRule>(vals, doffs, p, w, left, x,
                                               right, y);
}
template <typename T, int R, int Ui, int Ue, bool kSplit, bool kParam,
          int L, int kRule, int MB>
__global__ void __launch_bounds__(kThreads, MB)
step_bounded(const T* __restrict__ vals, const int* __restrict__ doffs,
             const __grid_constant__ LaunchPlan p, int64_t w,
             const T* __restrict__ left, const T* __restrict__ x,
             const T* __restrict__ right, T* __restrict__ y) {
  body<T, R, Ui, Ue, kSplit, kParam, L, kRule>(vals, doffs, p, w, left, x,
                                               right, y);
}
}  // namespace
"""

ENTRY = """
extern "C" int {name}(const void* vals, const void* doffs, LaunchPlan p,
    int64_t w, const void* left, const void* x, const void* right, void* y,
    void* stream) {{
  {kernel}<{T}, {R}, {Ui}, {Ue}, {split}, {param}, {L}, {rule}{mb}><<<
      static_cast<unsigned>(p.grid), kThreads, 0,
      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const {T}*>(vals), static_cast<const int*>(doffs), p, w,
      static_cast<const {T}*>(left), static_cast<const {T}*>(x),
      static_cast<const {T}*>(right), static_cast<{T}*>(y));
  return static_cast<int>(cudaGetLastError());
}}
"""

# name -> (R, Ui, Ue, split, param, load, rule, (least resident blocks in
# float, in double)): the design steps of csrc/dia_spmv.cu, each adding
# one to the one before; the kernel is s5
BOUNDS = (0, 0)        # none, as csrc/dia_spmv.cu
STEPS = {"s1 one body": (1, 0, 0, False, False, 0, 1, BOUNDS),
         "s2 + interior": (1, 0, 0, True, False, 0, 1, BOUNDS),
         "s3 + offsets by value": (1, 0, 0, True, True, 0, 1, BOUNDS),
         "s4 + batched loads": (1, 8, 8, True, True, 0, 1, BOUNDS),
         "s5 + streaming loads": (1, 8, 8, True, True, 1, 1, BOUNDS)}
# the alternatives measured for the steps that were kept, and the steps
# that were dropped (R rows a thread)
EXPLORE = {
    "s1 three-way rule": (1, 0, 0, False, False, 0, 0, BOUNDS),
    "s5 bounds 6, 4": (1, 8, 8, True, True, 1, 1, (6, 4)),
    "s5 bounds 8, 5": (1, 8, 8, True, True, 1, 1, (8, 5)),
    "s5 batch 4": (1, 4, 4, True, True, 1, 1, BOUNDS),
    "s5 batch 16": (1, 16, 16, True, True, 1, 1, BOUNDS),
    "s5 plain edge loop": (1, 8, 0, True, True, 1, 1, BOUNDS),
    "s5 no_allocate": (1, 8, 8, True, True, 2, 1, BOUNDS),
    "s5 R2": (2, 8, 8, True, True, 1, 1, BOUNDS),
    "s5 R4": (4, 8, 8, True, True, 1, 1, BOUNDS),
}


def step_plan(offsets, n, R):
    """The kernel's launch plan (sparse/dia_spmv_cuda.py:launch_plan) for
    blocks of R * THREADS rows, as the template's R rows a thread need."""
    p = b1.launch_plan(tuple(offsets), n)
    per_block = R * b1.THREADS
    begin = -(-p.lo // per_block)
    return b1.CPlan.of(dataclasses.replace(
        p, grid=-(-n // per_block), interior_begin=begin,
        interior_end=max(begin, max(p.hi, 0) // per_block)))


def nvcc(args):
    out = subprocess.run([cuda_build.nvcc(), *args], capture_output=True,
                         text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc {' '.join(args)}\n{out.stdout}{out.stderr}")
    return out.stdout + out.stderr


def build(source: Path, name: str):
    """(ctypes library, ptxas report) of one source built with the kernels'
    flags."""
    lib = BUILD / f"{name}.so"
    nvcc([*cuda_build.NVCC_FLAGS, "-o", str(lib), str(source)])
    report = nvcc([*cuda_build.NVCC_FLAGS[:4], "-cubin", "-Xptxas", "-v",
                   "-o", str(BUILD / f"{name}.cubin"), str(source)])
    return ctypes.CDLL(str(lib)), report


def steps_source(steps):
    text = [STEPS_SOURCE]
    for i, (R, Ui, Ue, split, param, L, rule, mb) in enumerate(
            steps.values()):
        for T, blocks in zip(("float", "double"), mb):
            text.append(ENTRY.format(name=f"step{i}_{T}", T=T, R=R, Ui=Ui,
                                     Ue=Ue,
                                     split=str(split).lower(),
                                     param=str(param).lower(), L=L,
                                     rule=rule,
                                     kernel="step_bounded" if blocks
                                     else "step",
                                     mb=f", {blocks}" if blocks else ""))
    path = BUILD / "steps.cu"
    path.write_text("".join(text))
    return path


def lattice_offsets(shifts, L):
    return tuple(sorted(a * L * L + b * L + c for a, b, c in shifts))


def shapes(dev, delaunay):
    """{label: (A, w or None, launches per solve)}: the matrices
    chip_smoke.py times B1 and the halo entry at."""
    f32, f64 = torch.float32, torch.float64
    A32 = cs._flagship_system(dev, f32)
    shifts = decompose_offsets(A32.offsets, A32.lattice)
    m = cs.N_FLAGSHIP
    mesh, dbc = generate.box_tet(0, 1, m, 0, 1, m, 0, 1, m)
    bc = np.zeros(mesh.n_node, bool)
    bc[dbc[:, 0].astype(np.int64)] = True
    arrays, _ = build_gmg(mesh, 1, bc, cs._poisson_fn, dtype=f32, device=dev)
    plan = structured.build_structured_plan(m, m, m)
    Ke, Fe = cs._poisson_fn(torch.as_tensor(
        to_element_minor(mesh.elem_coords()), dtype=f32, device=dev))
    A_full, _ = zero_dirichlet_rows(
        structured.assemble_dia_structured(Ke, plan),
        structured.assemble_rhs_structured(Fe, plan),
        torch.as_tensor(bc, device=dev),
        torch.zeros(mesh.n_node, dtype=f32, device=dev))
    del Ke, Fe
    n3 = cs.N_EL3D
    m3, _ = generate.box_tet(0, 1, n3, 0, 1, n3, 0, 1, n3)
    A_el3, _ = cs._assembled(m3, cs._clamped(m3), cs._elastic_fn(
        "tetra4", dmat_3d(cs.E_EL, cs.NU_EL)), f32, dev, ordered=False)
    m2 = generate.rect_tria(0, 2, cs.EL2D_CELLS[0], 0, 1, cs.EL2D_CELLS[1])
    A_el2, _ = cs._assembled(m2, cs._clamped(m2), cs._elastic_fn(
        "tria3", dmat_plane_stress(cs.E_EL, cs.NU_EL)), f64, dev,
        ordered=False)
    # the slabs of chip_smoke.py's phase 25 and the world-size-1 blocks of
    # its phase 26 (the n=96 block padded to whole planes, as the sharded
    # route lays it out; its pad rows zero here)
    gen = torch.Generator(device=dev).manual_seed(0)
    L = cs.N_SLAB - 1
    P = cs._slab_rows(L ** 3, cs.SLAB_RANKS, plane=L * L)
    Pe = cs._slab_rows(A_el3.n_rows, cs.EL3D_SLAB_RANKS)
    P96 = cs._slab_rows(A32.n_rows, 1, plane=(m - 1) ** 2)
    pad96 = torch.zeros(len(A32.offsets), P96 - A32.n_rows, device=dev)
    out = {
        "B1 n=96 lattice": (A32, None, "272 Jacobi, 609 Cheby, 91 IC(0)"),
        "B1 full system": (A_full, None, "24 GMG, 45 1e-8 (n=96)"),
        "B1 3D elasticity f32": (A_el3, None, "1,109"),
        "B1 3D elasticity f64": (DIAMatrix(
            vals=A_el3.vals.to(f64), offsets=A_el3.offsets,
            n_rows=A_el3.n_rows), None, "1,097 Jacobi"),
        "B1 2D elasticity f64": (A_el2, None, "7,778"),
        "B1 GMG 13^3 level": (arrays.mats[-1], None, "0 (dense inverse)"),
        "halo n=200 slab rank 1 of 8": (DIAMatrix(
            vals=torch.randn(15, P, generator=gen, device=dev),
            offsets=lattice_offsets(shifts, L), n_rows=P), "halos",
            "timed only"),
        "halo elasticity slab rank 1 of 4": (DIAMatrix(
            vals=A_el3.vals[:, Pe:2 * Pe].contiguous(),
            offsets=A_el3.offsets, n_rows=Pe), "halos", "timed only"),
        "halo world-1 n=96 block f32": (DIAMatrix(
            vals=torch.cat([A32.vals, pad96], 1), offsets=A32.offsets,
            n_rows=P96), None, "272"),
        "halo world-1 elasticity block f64": (DIAMatrix(
            vals=A_el3.vals.to(f64), offsets=A_el3.offsets,
            n_rows=A_el3.n_rows), None, "1,097 Jacobi, 1,045 bjacobi")}
    md, dd, _ = delaunay.result()
    dofmap = build_dofmap(md, 1, dd)
    asm = build_reduced_assembler(md, 1, dofmap, cs._poisson_fn, f32, dev)
    A0, _ = asm(torch.as_tensor(to_element_minor(md.elem_coords()),
                                dtype=f32, device=dev))
    ordering = build_ell_ordering(asm.pattern, md.coords[dofmap.assy_for_soln],
                                  dofmap.assy_for_soln % 1, dev, hybrid=True)
    out["B1 Delaunay dense part"] = (ordering.hybrid.pack(A0.vals).dia, None,
                                     "341")
    return out


def device_us(fn, reps=REPS, sleep_cycles=50_000_000):
    """Device microseconds per call, the host's cost hidden behind a sleep
    kernel (chip_smoke.py:_device_ms), and whether it was hidden."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(sleep_cycles)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    queued = 1e3 * (time.perf_counter() - t0)
    ev[2].record()
    ev[2].synchronize()
    return 1e3 * ev[1].elapsed_time(ev[2]) / reps, \
        queued < ev[0].elapsed_time(ev[1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="an earlier checkout")
    ap.add_argument("--explore", action="store_true")
    ap.add_argument("--out", type=Path,
                    default=BUILD / "dia_spmv_bench.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dia_spmv_bench.py needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    BUILD.mkdir(parents=True, exist_ok=True)
    mesher = ThreadPoolExecutor(1)
    delaunay = mesher.submit(cs._timed_delaunay, cs.N_DELAUNAY_F32)
    steps = dict(STEPS, **(EXPLORE if args.explore else {}))
    sources = {"kernel": b1.kernel.source, "steps": steps_source(steps)}
    if args.parent is not None:
        sources["parent"] = args.parent / "pfemfort_tpu_torch/csrc/dia_spmv.cu"
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        built = {k: pool.submit(build, src, k) for k, src in sources.items()}
        built = {k: f.result() for k, f in built.items()}
    b1.kernel.lib()
    reports = {}
    for k, (_, report) in built.items():
        reports[k] = [line.strip() for line in report.splitlines()
                      if "registers" in line or "spill" in line
                      or "Compiling" in line]
        print(json.dumps({"ptxas": k, "report": reports[k]}), flush=True)
        if k != "steps":
            args.out.parent.mkdir(parents=True, exist_ok=True)
            sass = subprocess.run(
                [str(Path(cuda_build.nvcc()).parent / "cuobjdump"), "-sass",
                 str(BUILD / f"{k}.cubin")], capture_output=True, text=True)
            (args.out.parent / f"{args.out.stem}_{k}.sass").write_text(
                sass.stdout + sass.stderr)
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)

    peak = next((v for k, v in cs.PEAK_GBPS.items()
                 if k in torch.cuda.get_device_name(0)), cs.PEAK_GBPS["H100"])
    rows = []
    for label, (A, halos, per_solve) in shapes(dev, delaunay).items():
        T = A.vals.dtype
        size = A.vals.element_size()
        tname = "float" if T == torch.float32 else "double"
        n, D = A.n_rows, len(A.offsets)
        x = torch.randn(n, dtype=T, device=dev)
        w = halo_width(A.offsets)
        left = right = None
        if halos:
            left, right = (torch.randn(w, dtype=T, device=dev)
                           for _ in range(2))
            csr, nnz = cs._halo_csr(A, w)
            xl = torch.cat([left, x, right])
            x_bytes = (n + 2 * w) * size
        else:
            csr, nnz = cs._csr_library(A)
            xl = x
            x_bytes = n * size
        nbytes = nnz * size + x_bytes + n * size + 4 * D
        ptr = lambda h: None if h is None else h.data_ptr()
        doffs = torch.tensor(A.offsets, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        y_ref = b1.dia_spmv_halo(A, x, left, right)
        run = {}
        if "parent" in built:
            lib = built["parent"][0]
            yp = torch.empty_like(x)
            if halos:
                fn = lib[f"dia_spmv_halo_{'f32' if size == 4 else 'f64'}"]
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p]
                call = (A.vals.data_ptr(), doffs.data_ptr(), D, n, w,
                        ptr(left), x.data_ptr(), ptr(right), yp.data_ptr(),
                        stream)
            else:
                # the parent's B1 rows ran its single-device entry, its
                # world-size-1 halo rows its halo entry with null halos
                halo = label.startswith("halo")
                fn = lib[f"dia_spmv_{'halo_' if halo else ''}"
                         f"{'f32' if size == 4 else 'f64'}"]
                fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int, ctypes.c_int64]
                               + [ctypes.c_int64, ctypes.c_void_p] * halo
                               + [ctypes.c_void_p] * (2 + halo)
                               + [ctypes.c_void_p])
                call = ((A.vals.data_ptr(), doffs.data_ptr(), D, n)
                        + (w, None) * halo + (x.data_ptr(),) + (None,) * halo
                        + (yp.data_ptr(), stream))
            run["parent"] = (lambda fn=fn, call=call: fn(*call), yp)
        lib = built["steps"][0]
        for i, (name, (R, *_)) in enumerate(steps.items()):
            fn = lib[f"step{i}_{tname}"]
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, b1.CPlan,
                           ctypes.c_int64] + [ctypes.c_void_p] * 5
            ys = torch.empty_like(x)
            call = (A.vals.data_ptr(), doffs.data_ptr(),
                    step_plan(A.offsets, n, R), w,
                    ptr(left), x.data_ptr(), ptr(right), ys.data_ptr(),
                    stream)
            run[name] = (lambda fn=fn, call=call: fn(*call), ys)
        run["kernel"] = ((lambda: b1.dia_spmv(A, x)) if label.startswith("B1")
                         else (lambda: b1.dia_spmv_halo(A, x, left, right)),
                         None)
        run["cusparse"] = (lambda: csr @ xl, None)
        for name, (fn, y) in run.items():
            fn()
        torch.cuda.synchronize()
        bit_equal = {name: bool(torch.equal(y, y_ref))
                     for name, (_, y) in run.items() if y is not None}
        lib_rel = float((run["cusparse"][0]() - y_ref).abs().max()
                        / y_ref.abs().max())
        times = {k: [] for k in run}
        hidden = True
        for name in [*run, *reversed(run)]:
            us, ok = device_us(run[name][0])
            times[name].append(us)
            hidden = hidden and ok
        us = {k: float(np.mean(v)) for k, v in times.items()}
        plan = b1.launch_plan(A.offsets, n)
        row = dict(
            shape=label, card=smi, rows=n, diagonals=D, dtype=str(T)[6:],
            halos=bool(halos), w=w, nnz=nnz, spmv_bytes=nbytes,
            layout_bytes=(D + 2) * n * size, per_solve=per_solve,
            bound_us=nbytes / (peak * 1e9) * 1e6, peak_gbps=peak,
            grid=plan.grid,
            interior_blocks=plan.interior_end - plan.interior_begin,
            device_us=us, device_us_runs=times, host_hidden=hidden,
            bit_equal_to_kernel=bit_equal, cusparse_rel_err=lib_rel,
            kernel_over_parent=us["kernel"] / us["parent"]
            if "parent" in us else None,
            kernel_over_cusparse=us["kernel"] / us["cusparse"])
        print(json.dumps(row), flush=True)
        rows.append(row)
        del csr
    mesher.shutdown()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": smi, "ptxas": reports,
                                    "steps": steps, "rows": rows}, indent=1))
    # the kernel and its steps hold the parent's sum order: the same bits
    bad = [r["shape"] for r in rows
           if not all(v for k, v in r["bit_equal_to_kernel"].items()
                      if k == "parent" or k in STEPS)
           or r["cusparse_rel_err"] > cs.REL_ERR_MAX[
               getattr(torch, r["dtype"])]]
    if bad:
        sys.exit(f"variants disagree with the kernel at {bad}")


if __name__ == "__main__":
    main()
