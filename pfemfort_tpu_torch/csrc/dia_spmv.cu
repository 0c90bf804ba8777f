// DIA sparse matrix-vector product for Hopper (sm_90a), kernel B1:
//
//     y[i] = sum_d vals[d * n + i] * x(i + offsets[d])
//
// with one read rule for x(j):
//
//     x(j) = left[w + j]   for -w <= j < 0   (a rank's left neighbour's last w)
//          = x[j]          for  0 <= j < n
//          = right[j - n]  for  n <= j < n + w (its right neighbour's first w)
//          = 0             elsewhere, and where left or right is null.
//
// It replaces the TPU kernel pfemfort_tpu/sparse/pallas_spmv.py:_kernel in
// both of its forms: the single-device product (_apply_dia_pallas_padded,
// the zero-padded x) and the in-shard product of a row-sharded system
// (apply_dia_pallas_halo, x padded with the halos; parallel/halo.py).  The
// single-device product is the halo product with both halos null, so one
// kernel body serves all four C entries below; dia_spmv_f32(A, x) and
// dia_spmv_halo_f32(A, x, null, null) run the same instructions.  It is
// written from the function, not from the Pallas structure: no 128-lane 2-D
// view, no lane roll, no duplicated x windows, no pre-padded value planes.
//
// Bound: device memory.  One product reads the D value planes (D * n values)
// and x, and writes y: (D + 2) * n * sizeof(T) bytes, 58 MB at n = 857,375,
// D = 15 in float, 169 MB at n = 345,744, D = 59 in double.  It does one
// multiply-add per value read.  The D shifted reads of x hit the same few
// lines for neighbouring rows and are served by L1/L2.  The design steps,
// each timed against the one before on an H100 (dia_spmv_bench.py; the
// times, and those below, in PERF.md):
//
//  * One body.  Every read goes through one rule, so the halo entry is no
//    longer a second kernel; the rule selects the base pointer of x(j) by
//    the side of [0, n) that j falls on and predicates one load on
//    jlo <= j < jhi.  The earlier halo kernel's three-way branches cost
//    up to 20% more at 59 diagonals.
//  * A test-free interior.  The host plan (sparse/dia_spmv_cuda.py:
//    launch_plan) finds the blocks whose every read i + offsets[d] lies in
//    [0, n); they read x[i + o] with no test, and only the few edge blocks
//    apply the rule.  The choice is one branch per block, so no warp
//    diverges.
//  * Offsets by value.  The plan packs the offsets once per offsets tuple
//    into the launch parameters (at most kMaxDiagonals, the port's DIA
//    census cap); the kernel reads them from the constant bank, the same
//    value for every thread of a warp: no load from device memory per
//    (row, diagonal), and no shared-memory staging, whose fill would need
//    a barrier in every block.
//  * More loads in flight.  The diagonals go in batches of kBatch = 8: a
//    batch's 8 value loads and 8 x reads are issued before its
//    multiply-adds, so a row waits on ceil(D / 8) rounds of loads, not D.
//    Batches of 4 lose up to 17% on float and tie on double; batches of
//    16 lose up to 35%.
//  * Streaming value loads.  The value planes are read once: they are
//    loaded with an evict-first hint (ld.global.cs), which leaves L1 and
//    L2 to x.  ld.global.nc.L1::no_allocate times within 5% of it.
//
// Dropped: R rows a thread (i, i + 256, ...), to put more bytes in flight
// per thread: at R = 2 or 4 the 2D elasticity double block gained 3-5%
// and every other shape lost, up to 2.7x at the 4-way elasticity slab.
// A cap on the registers (__launch_bounds__ with 6 or 8 blocks an SM)
// lost up to 31% on float and, at 5 blocks, 16% on double.  Staging x in
// shared memory with cp.async.bulk was not built: it was to be tried
// only if the 59-diagonal double block still lost to cuSPARSE, and the
// kernel is 18% faster than cuSPARSE there.
//
// Each row accumulates in the working type, in offset order, the order of
// the plain versions (sparse/dia.py:spmv_dia, spmv_dia_halo_local).  The
// compiler contracts each multiply and add into one fused multiply-add.
// A read outside [0, n) that the rule makes zero adds v * 0, as in the
// plain versions.  No diagonal is split across threads and no sum
// crosses lanes, so every launch gives the same bits.
//
// C entry points, one per type and form: they launch on the given stream,
// allocate nothing, do not synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

constexpr int kThreads = 256;
constexpr int kMaxDiagonals = 128;
constexpr int kBatch = 8;

// The host plan (sparse/dia_spmv_cuda.py:launch_plan), passed by value.
struct LaunchPlan {
  int64_t n;               // rows
  int64_t grid;            // blocks of kThreads rows
  int64_t interior_begin;  // blocks [interior_begin, interior_end) read
  int64_t interior_end;    // only inside [0, n)
  int32_t n_diag;
  int32_t offsets[kMaxDiagonals];
};

namespace {

// One row's sum, in offset order.  The diagonals go in batches of kBatch:
// a batch's value loads and x reads are all issued before its
// multiply-adds, so each thread has up to 2 * kBatch loads in flight and a
// row waits on ceil(D / kBatch) rounds of loads.  The last batch is
// masked past D.  `read(o)` is x(i + o); v walks the row's value planes.
template <typename T, typename Read>
__device__ __forceinline__ T row_sum(const T* v, int64_t n,
                                     const LaunchPlan& p, Read read) {
  T acc = T(0);
  for (int d = 0; d < p.n_diag; d += kBatch, v += kBatch * n) {
    T vv[kBatch], xx[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (d + u < p.n_diag) {
        vv[u] = __ldcs(v + u * n);
        xx[u] = read(p.offsets[d + u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (d + u < p.n_diag) acc += vv[u] * xx[u];
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const T* __restrict__ vals, const __grid_constant__ LaunchPlan p,
                int64_t w, const T* __restrict__ left,
                const T* __restrict__ x, const T* __restrict__ right,
                T* __restrict__ y) {
  const int64_t n = p.n;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  // The read rule, without a branch: x(j) lies at base + j, base chosen by
  // the side of [0, n) that j falls on, and the load is predicated on
  // jlo <= j < jhi (a null halo narrows the range to [0, n)).
  const int64_t jlo = left != nullptr ? -w : 0;
  const int64_t jhi = right != nullptr ? n + w : n;
  const auto lbase = reinterpret_cast<uintptr_t>(left) + w * sizeof(T);
  const auto xbase = reinterpret_cast<uintptr_t>(x);
  const auto rbase = reinterpret_cast<uintptr_t>(right) - n * sizeof(T);
  auto rule = [&](int64_t j) -> T {
    const uintptr_t base = j < 0 ? lbase : (j < n ? xbase : rbase);
    return (j >= jlo && j < jhi)
               ? __ldg(reinterpret_cast<const T*>(base + j * sizeof(T)))
               : T(0);
  };
  if (blockIdx.x >= p.interior_begin && blockIdx.x < p.interior_end)
    // every read of this block's rows lies in [0, n): no test
    y[i] = row_sum(vals + i, n, p,
                   [&](int64_t o) { return __ldg(x + (i + o)); });
  else if (i < n)
    y[i] = row_sum(vals + i, n, p, [&](int64_t o) { return rule(i + o); });
}

template <typename T>
int launch(const void* vals, const LaunchPlan& p, int64_t w, const void* left,
           const void* x, const void* right, void* y, void* stream) {
  if (p.n_diag < 0 || p.n_diag > kMaxDiagonals || p.grid < 0 ||
      p.grid > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.n > 0)
    dia_spmv_kernel<T><<<static_cast<unsigned>(p.grid), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(vals), p, w, static_cast<const T*>(left),
        static_cast<const T*>(x), static_cast<const T*>(right),
        static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int dia_spmv_f32(const void* vals, LaunchPlan plan, const void* x, void* y,
                 void* stream) {
  return launch<float>(vals, plan, 0, nullptr, x, nullptr, y, stream);
}

int dia_spmv_f64(const void* vals, LaunchPlan plan, const void* x, void* y,
                 void* stream) {
  return launch<double>(vals, plan, 0, nullptr, x, nullptr, y, stream);
}

int dia_spmv_halo_f32(const void* vals, LaunchPlan plan, int64_t w,
                      const void* left, const void* x, const void* right,
                      void* y, void* stream) {
  return launch<float>(vals, plan, w, left, x, right, y, stream);
}

int dia_spmv_halo_f64(const void* vals, LaunchPlan plan, int64_t w,
                      const void* left, const void* x, const void* right,
                      void* y, void* stream) {
  return launch<double>(vals, plan, w, left, x, right, y, stream);
}

const char* dia_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
