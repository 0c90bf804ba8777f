# Ported from pfemfort_tpu/native/__init__.py (samg_aggregate, ic0).
"""ctypes bindings of the host library csrc/host_native.cpp.

The library is built with the host C++ compiler at first use
(cuda_build.py:HostLibrary), never at import.  Unlike the JAX package,
which falls back to Python loops (and gives up on IC(0) above 200k rows)
when its native library is missing, a failed build raises here.
"""

from __future__ import annotations

import ctypes

import numpy as np

from pfemfort_tpu_torch.cuda_build import HostLibrary

_P64 = ctypes.POINTER(ctypes.c_int64)
_P32 = ctypes.POINTER(ctypes.c_int32)
_PD = ctypes.POINTER(ctypes.c_double)

library = HostLibrary("host_native", {
    "pfem_samg_aggregate": ([ctypes.c_int64, _P64, _P32, _P64],
                            ctypes.c_int64),
    "pfem_ic0": ([ctypes.c_int64, _P64, _P32, _PD], ctypes.c_int64),
})


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def samg_aggregate(indptr: np.ndarray, indices: np.ndarray, n: int):
    """Greedy SA aggregation over a strength CSR: (agg per node, n_agg)."""
    sp = np.ascontiguousarray(indptr, dtype=np.int64)
    si = np.ascontiguousarray(indices, dtype=np.int32)
    if sp.shape != (n + 1,) or (len(si) and (si.min() < 0 or si.max() >= n)):
        raise ValueError("samg_aggregate: indptr must have n + 1 entries and "
                         "every index lie in [0, n)")
    agg = np.empty(n, dtype=np.int64)
    n_agg = int(library.lib().pfem_samg_aggregate(
        n, _ptr(sp, ctypes.c_int64), _ptr(si, ctypes.c_int32),
        _ptr(agg, ctypes.c_int64)))
    return agg, n_agg


def ic0(indptr: np.ndarray, indices: np.ndarray, vals: np.ndarray) -> int:
    """In-place IC(0) of a lower-triangular CSR (diagonal last in each row,
    vals float64 and contiguous).  Returns the pivot-fixup count."""
    lp = np.ascontiguousarray(indptr, dtype=np.int64)
    li = np.ascontiguousarray(indices, dtype=np.int32)
    if vals.dtype != np.float64 or not vals.flags.c_contiguous \
            or vals.shape != (lp[-1],) or li.shape != vals.shape:
        raise ValueError("ic0: vals must be contiguous float64 with one "
                         "entry per index")
    return int(library.lib().pfem_ic0(len(lp) - 1, _ptr(lp, ctypes.c_int64),
                                      _ptr(li, ctypes.c_int32),
                                      _ptr(vals, ctypes.c_double)))
