// Sliced-ELL sparse matrix-vector product for Hopper (sm_90a):
//
//     y[r] = sum over the slots k of row r of vals[k] * x[cols[k]],
//
// where a column outside [0, n_cols) adds nothing.  The block may be
// rectangular (n_cols != n_rows); a sentinel column is n_cols itself, or
// 2 * n_rows + 128 after a row ordering.
//
// Replaces the TPU kernel pfemfort_tpu/sparse/slotgather.py:_kernel
// (launched by apply_slotgather).  That kernel re-packs padded (N, K) ELL
// into 128-lane "virtual rows" grouped by aligned x windows, because the TPU
// has no vector gather.  Hopper gathers in hardware.  What hurts here is
// padding: assembly/pattern.py rounds K up to the TPU's sublane (8), and a
// ragged block pads every row to its longest.  So the block comes in the
// sliced layout of sparse/sliced.py: 32 rows to a slice, each slice as wide
// as its longest row, slot k of the 32 rows contiguous, slice s starting at
// element slice_ptr[s] (int64, a multiple of 32).
//
// Bound: device memory.  One product must read each stored slot's value
// and int32 column once (12 or 8 bytes a slot), x once and write y once,
// for one multiply-add a slot: 2 flops per 8-12 bytes, far below the
// card's balance point, so tensor cores do not apply.  The x gather hits
// the 50 MB L2 (x is 3.4 MB at n=96 in float32, 8.4 MB for the 2D f64
// elasticity block).  The design serves the two slot streams:
//   * one warp owns one slice and one thread one row, so every slot is one
//     coalesced 128-byte (float32) or 256-byte (float64) load of values and
//     one of columns, and no padding beyond the slice's longest row is read;
//   * the streams are read with the evict-first hint (ld.global.cs) so that
//     x keeps its place in L2, and x through the read-only path;
//   * kUnroll slots go in flight at once: their values and columns, then
//     their x gathers, and only then are they added, strictly in slot
//     order, by one fused multiply-add chain that starts from 0.  So
//     repeated launches give the same bits, and a row sums in the order of
//     the (N, K) form.
// No shared memory: a ring of slot chunks filled by cp.async.bulk was
// tried and was slower at every solve shape (PERF.md), since a warp still
// waits on its own chunk while these loads keep kUnroll slots in flight.
//
// C entry points, one per type: they launch on the given stream, allocate
// nothing, do not synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSlice = 32;      // rows per slice: one warp
constexpr int kUnroll = 8;      // slots in flight per thread
constexpr int kThreads = 256;   // 8 slices per block pass

__device__ __forceinline__ float madd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double madd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

__device__ __forceinline__ int64_t slice_begin(const int64_t* ptr,
                                               int64_t s) {
  return __ldg(reinterpret_cast<const long long*>(ptr) + s);
}

__device__ __forceinline__ bool in_range(int j, int64_t n_cols) {
  return static_cast<int64_t>(static_cast<uint32_t>(j)) < n_cols;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sell_spmv(const T* __restrict__ vals, const int* __restrict__ cols,
          const int64_t* __restrict__ slice_ptr, int64_t n_rows,
          int64_t n_slices, int64_t n_cols, const T* __restrict__ x,
          T* __restrict__ y) {
  constexpr int kWarps = kThreads / kSlice;
  const int lane = threadIdx.x % kSlice;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * kWarps
                   + threadIdx.x / kSlice;
       s < n_slices; s += step) {
    const int64_t begin = slice_begin(slice_ptr, s);
    const int width = static_cast<int>((slice_begin(slice_ptr, s + 1) - begin)
                                       / kSlice);
    const T* v = vals + begin + lane;
    const int* c = cols + begin + lane;
    T acc = T(0);
    for (int k0 = 0; k0 < width; k0 += kUnroll) {
      T vk[kUnroll];
      int ck[kUnroll];
      T xk[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool live = k0 + u < width;
        ck[u] = live ? __ldcs(c + (k0 + u) * kSlice) : -1;
        vk[u] = live ? __ldcs(v + (k0 + u) * kSlice) : T(0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        xk[u] = in_range(ck[u], n_cols) ? __ldg(x + ck[u]) : T(0);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (in_range(ck[u], n_cols)) acc = madd(vk[u], xk[u], acc);
    }
    const int64_t row = s * kSlice + lane;
    if (row < n_rows) y[row] = acc;
  }
}

template <typename T>
int launch(const void* vals, const void* cols, const void* ptr,
           int64_t n_rows, int64_t n_cols, const void* x, void* y,
           void* stream) {
  const int64_t n_slices = (n_rows + kSlice - 1) / kSlice;
  if (n_slices > 0) {
    const int64_t blocks = (n_slices + kThreads / kSlice - 1)
                           / (kThreads / kSlice);
    sell_spmv<T><<<static_cast<int>(blocks < (1 << 20) ? blocks : (1 << 20)),
                   kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(vals), static_cast<const int*>(cols),
        static_cast<const int64_t*>(ptr), n_rows, n_slices, n_cols,
        static_cast<const T*>(x), static_cast<T*>(y));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ell_spmv_f32(const void* vals, const void* cols, const void* slice_ptr,
                 int64_t n_rows, int64_t n_cols, const void* x, void* y,
                 void* stream) {
  return launch<float>(vals, cols, slice_ptr, n_rows, n_cols, x, y, stream);
}

int ell_spmv_f64(const void* vals, const void* cols, const void* slice_ptr,
                 int64_t n_rows, int64_t n_cols, const void* x, void* y,
                 void* stream) {
  return launch<double>(vals, cols, slice_ptr, n_rows, n_cols, x, y, stream);
}

const char* ell_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
