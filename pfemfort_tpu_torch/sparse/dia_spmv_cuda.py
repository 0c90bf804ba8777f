"""Hand-written CUDA DIA SpMV (csrc/dia_spmv.cu) and its PyTorch binding.

Replaces the TPU kernel pfemfort_tpu/sparse/pallas_spmv.py:_kernel.  The
kernel is built and loaded by cuda_build.CudaKernel at first use.

`dia_spmv` is the one wrapper: a CPU tensor takes the plain version
(sparse/dia.py:spmv_dia); a CUDA tensor always launches the kernel, at any
size, in float32 or float64, or raises.  `kernel.launches` counts the
launches.
"""

from __future__ import annotations

import ctypes

import torch

from pfemfort_tpu_torch.cuda_build import CudaKernel
from pfemfort_tpu_torch.sparse.dia import DIAMatrix, spmv_dia

_ENTRY = {torch.float32: "dia_spmv_f32", torch.float64: "dia_spmv_f64"}
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]

kernel = CudaKernel("dia_spmv", {name: _ARGS for name in _ENTRY.values()})


def dia_spmv(A: DIAMatrix, x: torch.Tensor,
             offsets: torch.Tensor) -> torch.Tensor:
    """y = A x.

    offsets: A.offsets as an int32 tensor on A's device (made once by the
    caller, outside any iteration loop; the plain version does not read it).
    """
    if x.dtype not in _ENTRY or A.vals.dtype != x.dtype:
        raise TypeError(f"dia_spmv takes float32 or float64 values and x of "
                        f"one dtype, got {A.vals.dtype} and {x.dtype}")
    if x.device.type == "cpu":
        return spmv_dia(A, x)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmv: no kernel for device {x.device}")
    n, D = A.n_rows, len(A.offsets)
    vals = A.vals
    if not (vals.device == x.device == offsets.device):
        raise ValueError("dia_spmv: vals, offsets and x must share one device")
    if tuple(vals.shape) != (D, n) or not vals.is_contiguous():
        raise ValueError(f"dia_spmv: vals must be contiguous ({D}, {n}), "
                         f"got {tuple(vals.shape)}")
    if tuple(x.shape) != (n,) or not x.is_contiguous():
        raise ValueError(f"dia_spmv: x must be contiguous ({n},), "
                         f"got {tuple(x.shape)}")
    if (offsets.dtype != torch.int32 or tuple(offsets.shape) != (D,)
            or not offsets.is_contiguous()):
        raise ValueError("dia_spmv: offsets must be a contiguous int32 "
                         f"tensor of length {D}")
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        kernel.launch(_ENTRY[x.dtype], vals.data_ptr(), offsets.data_ptr(), D,
                      n, x.data_ptr(), y.data_ptr(), stream)
    return y
