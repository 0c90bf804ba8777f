// DIA sparse matrix-vector product for Hopper (sm_90a):
//
//     y[i] = sum_d vals[d * n + i] * x[i + offsets[d]],   x[j] = 0 outside [0, n)
//
// Replaces the TPU kernel pfemfort_tpu/sparse/pallas_spmv.py:_kernel (launched
// by _apply_dia_pallas_padded).  It is written from the function, not from the
// Pallas structure: no 128-lane 2-D view, no lane roll, no duplicated x
// windows and no pre-padded value planes.  The bounds test on i + offsets[d]
// takes the place of the zero pad.
//
// Bound: device memory.  One SpMV must read vals (D * n values) and x, and
// write y, so it moves at least (D + 2) * n * sizeof(T) bytes: 58 MB at
// n = 857,375, D = 15 in float.  It does one multiply-add per value read.
// The design serves that bound and nothing else: one thread per row, so a
// warp's reads of vals[d * n + i] are coalesced and every value is read once;
// the D shifted reads of x hit the same few cache lines for neighbouring rows
// and are served by L1/L2, not by device memory.  The offsets come from a
// small device array, so any number of diagonals is accepted.
//
// Each row accumulates in the working type, in offset order, the same order
// as the plain version (sparse/dia.py:spmv_dia).  The compiler may contract
// the multiply and add into one fused multiply-add.
//
// The halo entry (dia_spmv_halo_*) is the in-shard product of a row-sharded
// system (parallel/halo.py): the rank's P rows, with x given as three pieces,
//
//     x[j] = left[w + j]   for -w <= j < 0   (the left neighbour's last w)
//          = x_l[j]        for  0 <= j < P
//          = right[j - P]  for  P <= j < P + w (the right neighbour's first w)
//          = 0             elsewhere, and where left or right is null,
//
// so no (P + 2w) vector is concatenated in every iteration.  It replaces the
// halo form of the same TPU kernel (apply_dia_pallas_halo, which pads x with
// the halos).  It is a separate kernel: the single-device entries above keep
// their code and their timings.  Same bound, same one-thread-per-row design,
// same sum order (per row, in offset order, as parallel/halo.py's plain
// form).
//
// C entry points, one per type and form: they launch on the given stream,
// allocate nothing, do not synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const T* __restrict__ vals, const int* __restrict__ offsets,
                int n_diag, int64_t n, const T* __restrict__ x,
                T* __restrict__ y) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    T acc = T(0);
    for (int d = 0; d < n_diag; ++d) {
      const int64_t j = i + __ldg(offsets + d);
      const T xj = (j >= 0 && j < n) ? __ldg(x + j) : T(0);
      acc += __ldg(vals + static_cast<int64_t>(d) * n + i) * xj;
    }
    y[i] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmv_halo_kernel(const T* __restrict__ vals,
                     const int* __restrict__ offsets, int n_diag, int64_t n,
                     int64_t w, const T* __restrict__ left,
                     const T* __restrict__ x, const T* __restrict__ right,
                     T* __restrict__ y) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    T acc = T(0);
    for (int d = 0; d < n_diag; ++d) {
      const int64_t j = i + __ldg(offsets + d);
      T xj = T(0);
      if (j < 0) {
        if (left != nullptr && j >= -w) xj = __ldg(left + (w + j));
      } else if (j >= n) {
        if (right != nullptr && j < n + w) xj = __ldg(right + (j - n));
      } else {
        xj = __ldg(x + j);
      }
      acc += __ldg(vals + static_cast<int64_t>(d) * n + i) * xj;
    }
    y[i] = acc;
  }
}

int grid_for(int64_t n) {
  // Enough blocks for every row up to a cap; the grid-stride loop covers
  // the rest.  132 SMs x 16 resident blocks of 256 threads fills the card.
  const int64_t want = (n + kThreads - 1) / kThreads;
  return static_cast<int>(want < 65535 ? want : 65535);
}

template <typename T>
int launch_halo(const void* vals, const void* offsets, int n_diag, int64_t n,
                int64_t w, const void* left, const void* x, const void* right,
                void* y, void* stream) {
  if (n > 0) {
    dia_spmv_halo_kernel<T><<<grid_for(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(vals), static_cast<const int*>(offsets), n_diag,
        n, w, static_cast<const T*>(left), static_cast<const T*>(x),
        static_cast<const T*>(right), static_cast<T*>(y));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* vals, const void* offsets, int n_diag, int64_t n,
           const void* x, void* y, void* stream) {
  if (n > 0) {
    dia_spmv_kernel<T><<<grid_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(vals), static_cast<const int*>(offsets), n_diag,
        n, static_cast<const T*>(x), static_cast<T*>(y));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int dia_spmv_f32(const void* vals, const void* offsets, int n_diag, int64_t n,
                 const void* x, void* y, void* stream) {
  return launch<float>(vals, offsets, n_diag, n, x, y, stream);
}

int dia_spmv_f64(const void* vals, const void* offsets, int n_diag, int64_t n,
                 const void* x, void* y, void* stream) {
  return launch<double>(vals, offsets, n_diag, n, x, y, stream);
}

int dia_spmv_halo_f32(const void* vals, const void* offsets, int n_diag,
                      int64_t n, int64_t w, const void* left, const void* x,
                      const void* right, void* y, void* stream) {
  return launch_halo<float>(vals, offsets, n_diag, n, w, left, x, right, y,
                            stream);
}

int dia_spmv_halo_f64(const void* vals, const void* offsets, int n_diag,
                      int64_t n, int64_t w, const void* left, const void* x,
                      const void* right, void* y, void* stream) {
  return launch_halo<double>(vals, offsets, n_diag, n, w, left, x, right, y,
                             stream);
}

const char* dia_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
