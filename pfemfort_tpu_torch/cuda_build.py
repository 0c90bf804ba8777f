"""Build and load the port's native libraries.

Two kinds, each with a plain C interface, compiled at first use (never at
import) into pfemfort_tpu_torch/_build/ under a name keyed by a hash of the
source and the flags, and loaded with ctypes.  No PyTorch headers, so a
build takes seconds.

* `CudaKernel`: the hand-written CUDA kernels (csrc/*.cu), built with nvcc
  for sm_90a, a source once for each set of -D macros it is given (kernel
  B3 takes its element shape and type so).  Every entry point launches on
  the stream it is given, allocates nothing, does not synchronise and
  returns cudaGetLastError(); `<name>_error_string` turns that code into
  text.
* `HostLibrary`: host C++ (csrc/*.cpp), built with the host compiler (c++ or
  g++): the preconditioners' set-up loops (csrc/host_native.cpp).  A
  missing compiler raises; there is no Python loop in its place.

`HostProgram` builds a standalone host program the same way: its
csrc/<name>.cpp linked with the host library's source (the JAX package's
native/Makefile targets pfem_gentet and pfem_partition).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared", "-pthread")
PROGRAM_FLAGS = ("-O3", "-std=c++17", "-Wall", "-pthread")


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


def _compile_once(path: Path, compiler: Callable[[], str],
                  flags: Sequence[str], sources: Sequence[Path]) -> Path:
    """Compile `sources` into `path` unless it exists (the compiler is
    looked up only then).  The compiler writes a private file that is
    renamed into place, so processes that build at once do not read a
    half-written output."""
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [compiler(), *flags, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cmd[0]).name} failed "
                           f"({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _key(sources: Sequence[Path], flags: Sequence[str]) -> str:
    return hashlib.sha256(b"".join(p.read_bytes() for p in sources)
                          + " ".join(flags).encode()).hexdigest()[:16]


def host_compiler() -> str:
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++ or g++) on PATH: the "
                       "host library csrc/host_native.cpp cannot be built")


class _SharedLibrary:
    """One csrc/<name><suffix> source, its build and its loaded entries."""

    suffix = ""
    flags: Tuple[str, ...] = ()
    compiler: Callable[[], str]      # returns the compiler's path

    def __init__(self, name: str, entries: Dict[str, Tuple[Sequence, type]]):
        """entries: entry point name -> (ctypes argtypes, ctypes restype)."""
        self.name = name
        self.source = CSRC / f"{name}{self.suffix}"
        self.entries = dict(entries)
        self._lib = None

    def library_path(self) -> Path:
        return BUILD_DIR / f"{self.name}-{_key([self.source], self.flags)}.so"

    def build(self) -> Path:
        """Compile the library unless the one for this source exists."""
        return _compile_once(self.library_path(), self.compiler, self.flags,
                             [self.source])

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            for entry, (argtypes, restype) in self.entries.items():
                fn = getattr(lib, entry)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            self._lib = lib
        return self._lib


class CudaKernel(_SharedLibrary):
    """One csrc/<name>.cu library: its build, its entry points and the
    count of kernel launches made through `launch`, in all (`launches`) and
    by entry point (`entry_launches`)."""

    suffix = ".cu"
    flags = NVCC_FLAGS
    compiler = staticmethod(nvcc)

    def __init__(self, name: str, entries: Dict[str, Sequence],
                 defines: Sequence[str] = ()):
        """entries: entry point name -> ctypes argtypes (each returns int).
        defines: NAME=VALUE macros of this build (-D), one library each."""
        table = {e: (a, ctypes.c_int) for e, a in entries.items()}
        table[f"{name}_error_string"] = ([ctypes.c_int], ctypes.c_char_p)
        super().__init__(name, table)
        self.flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
        self.launches = 0
        self.entry_launches = collections.Counter()

    def launch(self, entry: str, *args) -> None:
        """Call one entry point; raise if the launch was refused, else count
        it.  The caller makes the launch's device current."""
        lib = self.lib()
        err = getattr(lib, entry)(*args)
        if err != 0:
            msg = getattr(lib, f"{self.name}_error_string")(err).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: {msg}")
        self.launches += 1
        self.entry_launches[entry] += 1


class HostLibrary(_SharedLibrary):
    """One csrc/<name>.cpp library of host functions."""

    suffix = ".cpp"
    flags = HOST_FLAGS
    compiler = staticmethod(host_compiler)


class HostProgram:
    """A standalone host program: csrc/<name>.cpp linked with the sources
    of `libraries` (HostLibrary), built at first use into _build/."""

    def __init__(self, name: str, *libraries: HostLibrary):
        self.name = name
        self.sources = [CSRC / f"{name}.cpp"] + [lib.source
                                                 for lib in libraries]

    def path(self) -> Path:
        return BUILD_DIR / f"{self.name}-{_key(self.sources, PROGRAM_FLAGS)}"

    def build(self) -> Path:
        """Compile the program unless the one for these sources exists;
        returns its path."""
        return _compile_once(self.path(), host_compiler, PROGRAM_FLAGS,
                             self.sources)
