"""Hand-written CUDA DIA SpMV (csrc/dia_spmv.cu) and its PyTorch binding.

Replaces the TPU kernel pfemfort_tpu/sparse/pallas_spmv.py:_kernel.  The
kernel is built with nvcc for sm_90a at first use, into
pfemfort_tpu_torch/_build/ under a name keyed by a hash of the source and
flags, and loaded with ctypes (plain C entry points, no PyTorch headers).

`dia_spmv` is the one wrapper: a CPU tensor takes the plain version
(sparse/dia.py:spmv_dia); a CUDA tensor always launches the kernel, at any
size, in float32 or float64, or raises.  `kernel.launches` counts the
launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from pfemfort_tpu_torch.sparse.dia import DIAMatrix, spmv_dia

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "dia_spmv.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
_ENTRY = {torch.float32: "dia_spmv_f32", torch.float64: "dia_spmv_f64"}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin or /usr/local/cuda/bin): "
            "the DIA SpMV kernel cannot be built")
    return path


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"dia_spmv-{key}.so"


def build() -> Path:
    """Compile the kernel unless the library for this source already exists.
    The compiler writes a private file that is renamed into place, so
    processes that build at once do not read a half-written library."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


class DiaSpmvKernel:
    """The loaded library and the count of kernel launches."""

    def __init__(self):
        self.launches = 0
        self._lib = None

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(build()))
            for name in _ENTRY.values():
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_int64, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            lib.dia_spmv_error_string.argtypes = [ctypes.c_int]
            lib.dia_spmv_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib


kernel = DiaSpmvKernel()


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
    lib = kernel.lib()
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = getattr(lib, _ENTRY[x.dtype])(
            vals.data_ptr(), offsets.data_ptr(), D, n, x.data_ptr(),
            y.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("dia_spmv kernel launch failed: "
                           + lib.dia_spmv_error_string(err).decode())
    kernel.launches += 1
    return y
