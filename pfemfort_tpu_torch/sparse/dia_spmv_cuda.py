"""Hand-written CUDA DIA SpMV (csrc/dia_spmv.cu) and its PyTorch binding.

Replaces the TPU kernel pfemfort_tpu/sparse/pallas_spmv.py:_kernel.  The
kernel is built and loaded by cuda_build.CudaKernel at first use.

`dia_spmv` is the single-device wrapper and `dia_spmv_halo` the in-shard
one (a rank's rows, x given with its neighbours' halos; parallel/halo.py):
a CPU tensor takes the plain version (sparse/dia.py:spmv_dia,
spmv_dia_halo_local); a CUDA tensor always launches the kernel, at any
size, in float32 or float64, or raises.  `kernel.launches` counts the
launches of both, `kernel.entry_launches` each entry's.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from pfemfort_tpu_torch.cuda_build import CudaKernel
from pfemfort_tpu_torch.sparse.dia import DIAMatrix, halo_extent, \
    spmv_dia, spmv_dia_halo_local

_ENTRY = {torch.float32: "dia_spmv_f32", torch.float64: "dia_spmv_f64"}
_HALO_ENTRY = {torch.float32: "dia_spmv_halo_f32",
               torch.float64: "dia_spmv_halo_f64"}
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_HALO_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
              ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]

kernel = CudaKernel("dia_spmv", {
    **{name: _ARGS for name in _ENTRY.values()},
    **{name: _HALO_ARGS for name in _HALO_ENTRY.values()}})


def _check_block(name: str, A: DIAMatrix, x: torch.Tensor,
                 offsets: torch.Tensor) -> None:
    """The device, dtype and shape checks of both entries, for a card
    tensor x of A.n_rows values."""
    n, D = A.n_rows, len(A.offsets)
    vals = A.vals
    if not (vals.device == x.device == offsets.device):
        raise ValueError(f"{name}: vals, offsets and x must share one device")
    if tuple(vals.shape) != (D, n) or not vals.is_contiguous():
        raise ValueError(f"{name}: vals must be contiguous ({D}, {n}), "
                         f"got {tuple(vals.shape)}")
    if tuple(x.shape) != (n,) or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous ({n},), "
                         f"got {tuple(x.shape)}")
    if (offsets.dtype != torch.int32 or tuple(offsets.shape) != (D,)
            or not offsets.is_contiguous()):
        raise ValueError(f"{name}: offsets must be a contiguous int32 "
                         f"tensor of length {D}")


def _check_dtype(name: str, A: DIAMatrix, *xs) -> None:
    if A.vals.dtype not in _ENTRY or any(
            x is not None and x.dtype != A.vals.dtype for x in xs):
        raise TypeError(f"{name} takes float32 or float64 values and vectors "
                        f"of one dtype, got {A.vals.dtype} and "
                        f"{[x.dtype for x in xs if x is not None]}")


def dia_spmv(A: DIAMatrix, x: torch.Tensor,
             offsets: torch.Tensor) -> torch.Tensor:
    """y = A x.

    offsets: A.offsets as an int32 tensor on A's device (made once by the
    caller, outside any iteration loop; the plain version does not read it).
    """
    _check_dtype("dia_spmv", A, x)
    if x.device.type == "cpu":
        return spmv_dia(A, x)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmv: no kernel for device {x.device}")
    _check_block("dia_spmv", A, x, offsets)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        kernel.launch(_ENTRY[x.dtype], A.vals.data_ptr(), offsets.data_ptr(),
                      len(A.offsets), A.n_rows, x.data_ptr(), y.data_ptr(),
                      stream)
    return y


def dia_spmv_halo(A_local: DIAMatrix, x_l: torch.Tensor,
                  left: Optional[torch.Tensor], right: Optional[torch.Tensor],
                  offsets: torch.Tensor) -> torch.Tensor:
    """y = A x for a rank's P rows (A_local: (D, P) values, n_rows = P),
    with x = [left (w) | x_l (P) | right (w)]; None stands for a halo of
    zeros (an edge rank's missing neighbour) and is not read.

    offsets: A_local.offsets as an int32 tensor on its device, made once by
    the caller (the plain version does not read it).
    """
    _check_dtype("dia_spmv_halo", A_local, x_l, left, right)
    w = halo_extent(A_local, left, right)
    if x_l.device.type == "cpu":
        return spmv_dia_halo_local(A_local, x_l, left, right)
    if x_l.device.type != "cuda":
        raise ValueError(f"dia_spmv_halo: no kernel for device {x_l.device}")
    _check_block("dia_spmv_halo", A_local, x_l, offsets)
    for h in (left, right):
        if h is not None and (h.device != x_l.device
                              or not h.is_contiguous()):
            raise ValueError("dia_spmv_halo: a halo must be contiguous on "
                             "x's device")
    ptr = lambda h: None if h is None else h.data_ptr()
    y = torch.empty_like(x_l)
    stream = torch.cuda.current_stream(x_l.device).cuda_stream
    with torch.cuda.device(x_l.device):
        kernel.launch(_HALO_ENTRY[x_l.dtype], A_local.vals.data_ptr(),
                      offsets.data_ptr(), len(A_local.offsets),
                      A_local.n_rows, w, ptr(left), x_l.data_ptr(),
                      ptr(right), y.data_ptr(), stream)
    return y
