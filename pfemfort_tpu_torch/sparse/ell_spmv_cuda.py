"""Hand-written CUDA sliced-ELL SpMV (csrc/ell_spmv.cu) and its binding.

Replaces the TPU kernel pfemfort_tpu/sparse/slotgather.py:_kernel.  The
kernel reads a block in the sliced layout of sparse/sliced.py (32 rows to a
slice, each slice as wide as its longest row, slot-major): the slot-gather
re-pack existed only because the TPU has no vector gather, and the (N, K)
form's padding is work the card need not do.  It is built and loaded by
cuda_build.CudaKernel at first use.

`ell_spmv` is the one wrapper, and it takes a SlicedELL: a CPU tensor takes
the plain version (sparse/spmv.py:spmv_sliced); a CUDA tensor always
launches the kernel, in float32 or float64, for any slice widths and any
n_cols (rectangular blocks), or raises.  A padded ELLMatrix raises: lay it
out once with sparse/sliced.py:slice_ell.  `kernel.launches` counts the
launches.
"""

from __future__ import annotations

import ctypes

import torch

from pfemfort_tpu_torch.cuda_build import CudaKernel
from pfemfort_tpu_torch.sparse.formats import ELLMatrix
from pfemfort_tpu_torch.sparse.sliced import SLICE, SlicedELL
from pfemfort_tpu_torch.sparse.spmv import spmv_sliced

_ENTRY = {torch.float32: "ell_spmv_f32", torch.float64: "ell_spmv_f64"}
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]

kernel = CudaKernel("ell_spmv", {name: _ARGS for name in _ENTRY.values()})


def ell_spmv(A: SlicedELL, x: torch.Tensor) -> torch.Tensor:
    """y = A x for x of length A.n_cols."""
    if isinstance(A, ELLMatrix):
        raise TypeError("ell_spmv takes a SlicedELL: lay the padded "
                        "ELLMatrix out once with sparse.sliced.slice_ell "
                        "(or ell_to_sliced), outside the product")
    if x.dtype not in _ENTRY or A.vals.dtype != x.dtype:
        raise TypeError(f"ell_spmv takes float32 or float64 values and x of "
                        f"one dtype, got {A.vals.dtype} and {x.dtype}")
    if tuple(x.shape) != (A.n_cols,):
        raise ValueError(f"ell_spmv: x must have shape ({A.n_cols},), "
                         f"got {tuple(x.shape)}")
    cols, vals, ptr = A.cols, A.vals, A.slice_ptr
    if not (vals.device == cols.device == ptr.device == x.device):
        raise ValueError("ell_spmv: the block and x must share one device")
    if x.device.type == "cpu":
        return spmv_sliced(A, x)
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmv: no kernel for device {x.device}")
    if cols.dtype != torch.int32 or cols.dim() != 1 \
            or not cols.is_contiguous():
        raise ValueError("ell_spmv: cols must be a contiguous 1-D int32 "
                         "tensor")
    if tuple(vals.shape) != tuple(cols.shape) or not vals.is_contiguous():
        raise ValueError(f"ell_spmv: vals must be contiguous "
                         f"{tuple(cols.shape)}, got {tuple(vals.shape)}")
    n_slices = -(-A.n_rows // SLICE)
    if ptr.dtype != torch.int64 or tuple(ptr.shape) != (n_slices + 1,) \
            or not ptr.is_contiguous():
        raise ValueError(f"ell_spmv: slice_ptr must be a contiguous int64 "
                         f"({n_slices + 1},) tensor")
    if not x.is_contiguous():
        raise ValueError("ell_spmv: x must be contiguous")
    y = torch.empty(A.n_rows, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        kernel.launch(_ENTRY[x.dtype], vals.data_ptr(), cols.data_ptr(),
                      ptr.data_ptr(), A.n_rows, A.n_cols, x.data_ptr(),
                      y.data_ptr(), stream)
    return y
