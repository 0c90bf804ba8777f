"""Hand-written CUDA padded-ELL SpMV (csrc/ell_spmv.cu) and its binding.

Replaces the TPU kernel pfemfort_tpu/sparse/slotgather.py:_kernel.  The
kernel reads the (N, K) cols and vals directly: the slot-gather re-pack
existed only because the TPU has no vector gather.  It is built and loaded
by cuda_build.CudaKernel at first use.

`ell_spmv` is the one wrapper: a CPU tensor takes the plain version
(sparse/spmv.py:spmv_ell); a CUDA tensor always launches the kernel, in
float32 or float64, for any K and any n_cols (rectangular blocks), or
raises.  `kernel.launches` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from pfemfort_tpu_torch.cuda_build import CudaKernel
from pfemfort_tpu_torch.sparse.formats import ELLMatrix
from pfemfort_tpu_torch.sparse.spmv import spmv_ell

_ENTRY = {torch.float32: "ell_spmv_f32", torch.float64: "ell_spmv_f64"}
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
         ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]

kernel = CudaKernel("ell_spmv", {name: _ARGS for name in _ENTRY.values()})


def ell_spmv(A: ELLMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x for x of length A.n_cols."""
    if x.dtype not in _ENTRY or A.vals.dtype != x.dtype:
        raise TypeError(f"ell_spmv takes float32 or float64 values and x of "
                        f"one dtype, got {A.vals.dtype} and {x.dtype}")
    if tuple(x.shape) != (A.n_cols,):
        raise ValueError(f"ell_spmv: x must have shape ({A.n_cols},), "
                         f"got {tuple(x.shape)}")
    cols, vals = A.cols, A.vals
    if not (vals.device == cols.device == x.device):
        raise ValueError("ell_spmv: cols, vals and x must share one device")
    if x.device.type == "cpu":
        return spmv_ell(A, x)
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmv: no kernel for device {x.device}")
    n, k = cols.shape
    if cols.dtype != torch.int32 or not cols.is_contiguous():
        raise ValueError("ell_spmv: cols must be a contiguous int32 tensor")
    if tuple(vals.shape) != (n, k) or not vals.is_contiguous():
        raise ValueError(f"ell_spmv: vals must be contiguous ({n}, {k}), "
                         f"got {tuple(vals.shape)}")
    if not x.is_contiguous():
        raise ValueError("ell_spmv: x must be contiguous")
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        kernel.launch(_ENTRY[x.dtype], vals.data_ptr(), cols.data_ptr(), n, k,
                      A.n_cols, x.data_ptr(), y.data_ptr(), stream)
    return y
