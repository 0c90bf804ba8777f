"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

Each source has a plain C interface: every entry point launches on the
stream it is given, allocates nothing, does not synchronise and returns
cudaGetLastError(); `<name>_error_string` turns that code into text.  A
source is compiled with nvcc for sm_90a at first use (never at import),
into pfemfort_tpu_torch/_build/ under a name keyed by a hash of the source
and the flags, and loaded with ctypes: no PyTorch headers, so a build takes
seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin or /usr/local/cuda/bin): "
            "the CUDA kernels cannot be built")
    return path


class CudaKernel:
    """One csrc/<name>.cu library: its build, its entry points and the
    count of kernel launches made through `launch`."""

    def __init__(self, name: str, entries: Dict[str, Sequence]):
        """entries: entry point name -> ctypes argtypes (each returns int)."""
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.entries = dict(entries)
        self.launches = 0
        self._lib = None

    def library_path(self) -> Path:
        key = hashlib.sha256(self.source.read_bytes()
                             + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"{self.name}-{key}.so"

    def build(self) -> Path:
        """Compile the library unless the one for this source exists.  The
        compiler writes a private file that is renamed into place, so
        processes that build at once do not read a half-written library."""
        path = self.library_path()
        if path.exists():
            return path
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
        return path

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            for entry, argtypes in self.entries.items():
                fn = getattr(lib, entry)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            err = getattr(lib, f"{self.name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, entry: str, *args) -> None:
        """Call one entry point; raise if the launch was refused, else count
        it.  The caller makes the launch's device current."""
        lib = self.lib()
        err = getattr(lib, entry)(*args)
        if err != 0:
            msg = getattr(lib, f"{self.name}_error_string")(err).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: {msg}")
        self.launches += 1
