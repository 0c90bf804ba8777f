"""Hand-written CUDA DIA SpMV (csrc/dia_spmv.cu, kernel B1) and its PyTorch
binding.

Replaces the TPU kernel pfemfort_tpu/sparse/pallas_spmv.py:_kernel in both
its forms (apply_dia_pallas, apply_dia_pallas_halo).  The kernel is built
and loaded by cuda_build.CudaKernel at first use.

One kernel body, two wrappers: `dia_spmv` is the single-device product and
`dia_spmv_halo` the in-shard one (a rank's rows, x given with its
neighbours' halos; parallel/halo.py).  The single-device product is the
halo product with both halos None, so `dia_spmv(A, x)` and
`dia_spmv_halo(A, x, None, None)` give the same bits.  A CPU tensor takes
the plain version (sparse/dia.py:spmv_dia, spmv_dia_halo_local); a CUDA
tensor always launches the kernel, at any size, in float32 or float64, or
raises.  `kernel.launches` counts the launches of both, and
`kernel.entry_launches` each entry's.

The offsets are read on the host from A.offsets (a tuple), with no
device copy: `launch_plan` packs them into the launch parameters beside
the grid and the interior blocks (those that read x with no bounds
test), made once per offsets tuple and size.  The kernel takes at most
MAX_DIAGONALS diagonals, the port's DIA census cap (assembly/pattern.py:
build_pattern's max_offsets); more raise ValueError on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from pfemfort_tpu_torch.cuda_build import CudaKernel
from pfemfort_tpu_torch.sparse.dia import DIAMatrix, halo_extent, \
    spmv_dia, spmv_dia_halo_local

THREADS = 256                 # csrc/dia_spmv.cu:kThreads, rows a block
MAX_DIAGONALS = 128           # csrc/dia_spmv.cu:kMaxDiagonals


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One launch of kernel B1 for n rows and an offsets tuple.

    Block b owns rows b * THREADS + t (t < THREADS) that are below n.
    Blocks [interior_begin, interior_end) own only rows of [lo, hi), whose
    every read i + offsets[d] lies in [0, n): they read x with no test.
    `packed` is the offsets padded with zeros to MAX_DIAGONALS values, the
    first n_diag in use."""
    n: int
    n_diag: int
    grid: int
    lo: int
    hi: int
    interior_begin: int
    interior_end: int
    packed: Tuple[int, ...]


def launch_plan(offsets: Tuple[int, ...], n: int) -> LaunchPlan:
    """The host side of one launch for an (n, len(offsets)) block: grid,
    interior blocks and packed offsets.  The offsets need not be sorted
    and may reach past +-n."""
    offsets = tuple(int(o) for o in offsets)
    if len(offsets) > MAX_DIAGONALS:
        raise ValueError(f"kernel B1 takes at most {MAX_DIAGONALS} diagonals,"
                         f" got {len(offsets)}")
    lo = max(0, -min(offsets, default=0))
    hi = n - max(0, max(offsets, default=0))
    begin = -(-lo // THREADS)
    return LaunchPlan(n=n, n_diag=len(offsets), grid=-(-n // THREADS),
                      lo=lo, hi=hi, interior_begin=begin,
                      interior_end=max(begin, max(hi, 0) // THREADS),
                      packed=offsets + (0,) * (MAX_DIAGONALS - len(offsets)))


class CPlan(ctypes.Structure):
    """csrc/dia_spmv.cu:LaunchPlan, passed by value."""
    _fields_ = [("n", ctypes.c_int64), ("grid", ctypes.c_int64),
                ("interior_begin", ctypes.c_int64),
                ("interior_end", ctypes.c_int64),
                ("n_diag", ctypes.c_int32),
                ("offsets", ctypes.c_int32 * MAX_DIAGONALS)]

    @classmethod
    def of(cls, p: LaunchPlan) -> "CPlan":
        return cls(p.n, p.grid, p.interior_begin, p.interior_end, p.n_diag,
                   (ctypes.c_int32 * MAX_DIAGONALS)(*p.packed))


@functools.lru_cache(maxsize=256)
def _c_plan(offsets: Tuple[int, ...], n: int) -> CPlan:
    return CPlan.of(launch_plan(offsets, n))


_ENTRY = {torch.float32: "dia_spmv_f32", torch.float64: "dia_spmv_f64"}
_HALO_ENTRY = {torch.float32: "dia_spmv_halo_f32",
               torch.float64: "dia_spmv_halo_f64"}
_ARGS = [ctypes.c_void_p, CPlan, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p]
_HALO_ARGS = [ctypes.c_void_p, CPlan, ctypes.c_int64, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p]

kernel = CudaKernel("dia_spmv", {
    **{name: _ARGS for name in _ENTRY.values()},
    **{name: _HALO_ARGS for name in _HALO_ENTRY.values()}})


def _check_block(name: str, A: DIAMatrix, x: torch.Tensor) -> CPlan:
    """The device, shape and size checks of both entries, for a card
    tensor x of A.n_rows values; returns the launch's plan."""
    n, D = A.n_rows, len(A.offsets)
    vals = A.vals
    if vals.device != x.device:
        raise ValueError(f"{name}: vals and x must share one device")
    if tuple(vals.shape) != (D, n) or not vals.is_contiguous():
        raise ValueError(f"{name}: vals must be contiguous ({D}, {n}), "
                         f"got {tuple(vals.shape)}")
    if tuple(x.shape) != (n,) or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous ({n},), "
                         f"got {tuple(x.shape)}")
    return _c_plan(A.offsets, n)


def _check_dtype(name: str, A: DIAMatrix, *xs) -> None:
    if A.vals.dtype not in _ENTRY or any(
            x is not None and x.dtype != A.vals.dtype for x in xs):
        raise TypeError(f"{name} takes float32 or float64 values and vectors "
                        f"of one dtype, got {A.vals.dtype} and "
                        f"{[x.dtype for x in xs if x is not None]}")


def dia_spmv(A: DIAMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x."""
    _check_dtype("dia_spmv", A, x)
    if x.device.type == "cpu":
        return spmv_dia(A, x)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmv: no kernel for device {x.device}")
    plan = _check_block("dia_spmv", A, x)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        kernel.launch(_ENTRY[x.dtype], A.vals.data_ptr(), plan, x.data_ptr(),
                      y.data_ptr(), stream)
    return y


def dia_spmv_halo(A_local: DIAMatrix, x_l: torch.Tensor,
                  left: Optional[torch.Tensor],
                  right: Optional[torch.Tensor]) -> torch.Tensor:
    """y = A x for a rank's P rows (A_local: (D, P) values, n_rows = P),
    with x = [left (w) | x_l (P) | right (w)]; None stands for a halo of
    zeros (an edge rank's missing neighbour) and is not read."""
    _check_dtype("dia_spmv_halo", A_local, x_l, left, right)
    w = halo_extent(A_local, left, right)
    if x_l.device.type == "cpu":
        return spmv_dia_halo_local(A_local, x_l, left, right)
    if x_l.device.type != "cuda":
        raise ValueError(f"dia_spmv_halo: no kernel for device {x_l.device}")
    plan = _check_block("dia_spmv_halo", A_local, x_l)
    for h in (left, right):
        if h is not None and (h.device != x_l.device
                              or not h.is_contiguous()):
            raise ValueError("dia_spmv_halo: a halo must be contiguous on "
                             "x's device")
    ptr = lambda h: None if h is None else h.data_ptr()
    y = torch.empty_like(x_l)
    stream = torch.cuda.current_stream(x_l.device).cuda_stream
    with torch.cuda.device(x_l.device):
        kernel.launch(_HALO_ENTRY[x_l.dtype], A_local.vals.data_ptr(), plan,
                      w, ptr(left), x_l.data_ptr(), ptr(right), y.data_ptr(),
                      stream)
    return y
