// Padded-ELL sparse matrix-vector product for Hopper (sm_90a):
//
//     y[r] = sum_{k = 0 .. K-1} vals[r * K + k] * x[cols[r * K + k]],
//
// where a column outside [0, n_cols) adds nothing.  The block may be
// rectangular (n_cols != n_rows); padded slots carry a sentinel column
// >= n_cols (n_cols itself, or 2 * n_rows + 128 after a row ordering).
//
// Replaces the TPU kernel pfemfort_tpu/sparse/slotgather.py:_kernel
// (launched by apply_slotgather).  That kernel re-packs the (N, K) arrays
// into 128-lane "virtual rows" grouped by aligned x windows, because the TPU
// has no vector gather.  Hopper gathers in hardware, so this kernel reads
// the (N, K) cols and vals as they are: no re-pack, no padded copy of x (a
// bounds test drops a sentinel column).
//
// Bound: device memory.  One SpMV must read vals and cols (K * N each) and
// x, and write y: (2K + 2) * N * 4 bytes in float32 (116.6 MB at
// N = 857,375, K = 16), one multiply-add per slot.  The x gather hits the
// 50 MB L2 (x is 3.4 MB there) and, under a bandwidth-reducing row order,
// the same few cache lines for neighbouring rows.  The design serves the
// value and column streams: a block of 128 threads owns 128 consecutive
// rows, stages their slots through shared memory in passes of 16 with
// coalesced loads (neighbouring threads read neighbouring slots), and then
// each thread walks its own row.  The shared rows are padded by one word so
// that the row walk is free of bank conflicts.
//
// Each row accumulates in the working type in slot order k = 0 .. K-1, so
// two launches on the same input give the same bits.  The compiler may
// contract the multiply and add into one fused multiply-add.
//
// C entry points, one per type: they launch on the given stream, allocate
// nothing, do not synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 128;   // rows per tile, one thread each
constexpr int kSlots = 16;   // slots staged per pass

template <typename T>
__global__ void __launch_bounds__(kRows)
ell_spmv_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                int64_t n_rows, int k, int64_t n_cols,
                const T* __restrict__ x, T* __restrict__ y) {
  __shared__ T s_vals[kRows][kSlots + 1];
  __shared__ int s_cols[kRows][kSlots + 1];
  const int t = threadIdx.x;
  const int64_t n_tiles = (n_rows + kRows - 1) / kRows;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row0 = tile * kRows;
    const int64_t left = n_rows - row0;
    const int rows = left < kRows ? static_cast<int>(left) : kRows;
    T acc = T(0);
    for (int k0 = 0; k0 < k; k0 += kSlots) {
      const int kt = k - k0 < kSlots ? k - k0 : kSlots;
      for (int e = t; e < rows * kt; e += kRows) {
        const int r = e / kt;
        const int c = e - r * kt;
        const int64_t src = (row0 + r) * k + k0 + c;
        s_vals[r][c] = __ldg(vals + src);
        s_cols[r][c] = __ldg(cols + src);
      }
      __syncthreads();
      if (t < rows) {
        for (int c = 0; c < kt; ++c) {
          const int j = s_cols[t][c];
          if (j >= 0 && j < n_cols) acc += s_vals[t][c] * __ldg(x + j);
        }
      }
      __syncthreads();
    }
    if (t < rows) y[row0 + t] = acc;
  }
}

template <typename T>
int launch(const void* vals, const void* cols, int64_t n_rows, int k,
           int64_t n_cols, const void* x, void* y, void* stream) {
  if (n_rows > 0) {
    // One block per tile of rows up to a cap; the grid-stride loop covers
    // the rest.
    const int64_t tiles = (n_rows + kRows - 1) / kRows;
    const int blocks = static_cast<int>(tiles < (1 << 20) ? tiles : (1 << 20));
    ell_spmv_kernel<T><<<blocks, kRows, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(vals), static_cast<const int*>(cols), n_rows, k,
        n_cols, static_cast<const T*>(x), static_cast<T*>(y));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ell_spmv_f32(const void* vals, const void* cols, int64_t n_rows, int k,
                 int64_t n_cols, const void* x, void* y, void* stream) {
  return launch<float>(vals, cols, n_rows, k, n_cols, x, y, stream);
}

int ell_spmv_f64(const void* vals, const void* cols, int64_t n_rows, int k,
                 int64_t n_cols, const void* x, void* y, void* stream) {
  return launch<double>(vals, cols, n_rows, k, n_cols, x, y, stream);
}

const char* ell_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
