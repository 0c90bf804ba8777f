# Ported from pfemfort_tpu/native/__init__.py (rcb_partition, greedy_partition, edge_cut, gen_tet_mesh, ell_pattern, samg_aggregate, ic0) and native/Makefile (the two programs).
"""ctypes bindings of the host library csrc/host_native.cpp.

The library is built with the host C++ compiler at first use
(cuda_build.py:HostLibrary), never at import.  Unlike the JAX package,
which falls back to Python or numpy (and gives up on IC(0) above 200k rows)
when its native library is missing, a failed build raises here.  The one
fallback kept is the JAX package's own size rule: `ell_pattern` returns None
when an index would overflow int32, and assembly/pattern.py then takes its
numpy builder.  `offset_census`, the port's own, has no fallback and raises
on such input.

The two standalone programs of the JAX package's native/Makefile,
`pfem_gentet` (box -> 6-tet .dat files) and `pfem_partition` (RCB or greedy
partition, edge cut, VTK), are built the same way from csrc/<name>.cpp and
the library's source: `binary(name)` returns the built program's path.
"""

from __future__ import annotations

import ctypes

import numpy as np

from pfemfort_tpu_torch.cuda_build import HostLibrary, HostProgram

_P64 = ctypes.POINTER(ctypes.c_int64)
_P32 = ctypes.POINTER(ctypes.c_int32)
_PD = ctypes.POINTER(ctypes.c_double)

library = HostLibrary("host_native", {
    "pfem_rcb_partition": ([_PD, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                            _P32], None),
    "pfem_greedy_partition": ([_P32, ctypes.c_int64, ctypes.c_int,
                               ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                               _P32], None),
    "pfem_edge_cut": ([_P32, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
                       ctypes.c_int, _P32], ctypes.c_int64),
    "pfem_ell_pattern": ([_P32, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
                          ctypes.c_int32, _P32, _P32, _P64, _P32, _P32],
                         ctypes.c_int64),
    "pfem_offset_census": ([_P32, ctypes.c_int64, ctypes.c_int32,
                            ctypes.c_int64, _P64], ctypes.c_int64),
    "pfem_samg_aggregate": ([ctypes.c_int64, _P64, _P32, _P64],
                            ctypes.c_int64),
    "pfem_ic0": ([ctypes.c_int64, _P64, _P32, _PD], ctypes.c_int64),
    "pfem_gen_tet_mesh": ([ctypes.c_double, ctypes.c_double, ctypes.c_int64,
                           ctypes.c_double, ctypes.c_double, ctypes.c_int64,
                           ctypes.c_double, ctypes.c_double, ctypes.c_int64,
                           ctypes.c_char_p], ctypes.c_int),
})

PROGRAMS = {name: HostProgram(name, library)
            for name in ("pfem_gentet", "pfem_partition")}


def binary(name: str) -> str:
    """The path of the standalone program `name` ('pfem_gentet' or
    'pfem_partition'), built at first use:

      pfem_gentet x0 x1 nEx y0 y1 nEy z0 z1 nEz [prefix=mesh]
      pfem_partition ndim npe method(0=rcb,1=greedy) nparts nodes elems
                     [out.vtk]"""
    if name not in PROGRAMS:
        raise ValueError(f"binary({name!r}): one of {sorted(PROGRAMS)}")
    return str(PROGRAMS[name].build())


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def rcb_partition(centroids: np.ndarray, nparts: int) -> np.ndarray:
    """Recursive coordinate bisection of (n, dim) points into nparts."""
    c = np.ascontiguousarray(centroids, dtype=np.float64)
    n, dim = c.shape
    out = np.empty(n, dtype=np.int32)
    library.lib().pfem_rcb_partition(_ptr(c, ctypes.c_double), n, dim, nparts,
                                     _ptr(out, ctypes.c_int32))
    return out


def greedy_partition(conn: np.ndarray, n_node: int, ncommon: int,
                     nparts: int) -> np.ndarray:
    """Greedy BFS k-way partition of the element dual graph (elements
    adjacent iff they share >= ncommon nodes)."""
    c = np.ascontiguousarray(conn, dtype=np.int32)
    n_elem, npe = c.shape
    out = np.empty(n_elem, dtype=np.int32)
    library.lib().pfem_greedy_partition(_ptr(c, ctypes.c_int32), n_elem, npe,
                                        n_node, ncommon, nparts,
                                        _ptr(out, ctypes.c_int32))
    return out


def edge_cut(conn: np.ndarray, n_node: int, ncommon: int,
             part: np.ndarray) -> int:
    """Dual-graph edges between elements of different parts."""
    c = np.ascontiguousarray(conn, dtype=np.int32)
    p = np.ascontiguousarray(part, dtype=np.int32)
    if p.shape != (c.shape[0],):
        raise ValueError("edge_cut: one part id per element")
    return int(library.lib().pfem_edge_cut(_ptr(c, ctypes.c_int32),
                                           c.shape[0], c.shape[1], n_node,
                                           ncommon, _ptr(p, ctypes.c_int32)))


def gen_tet_mesh(x0, x1, nex, y0, y1, ney, z0, z1, nez, prefix: str) -> None:
    """Write <prefix>-nodes.dat / -elems.dat / -DirichBC.dat of the box
    [x0,x1]x[y0,y1]x[z0,z1] split into nex*ney*nez*6 tets (1-based; the
    Dirichlet values u = x^2+y^2+z^2 on the boundary nodes)."""
    rc = library.lib().pfem_gen_tet_mesh(x0, x1, nex, y0, y1, ney, z0, z1,
                                         nez, prefix.encode())
    if rc != 0:
        raise IOError(f"pfem_gen_tet_mesh failed writing {prefix}-*.dat")


def ell_pattern(elem_dof: np.ndarray, n_rows: int, lane_pad: int = 8):
    """CSR + padded-ELL pattern + sorted scatter plan from element DOF rows
    (-1 for an eliminated dof): (mat_perm, mat_segids, indptr, indices,
    ell_k, nnz), the arrays of the numpy builder bit for bit; None when an
    index would overflow int32."""
    E, ns = np.shape(elem_dof)
    n_ent = E * ns * ns
    if n_ent >= 2**31:
        return None
    ed = np.ascontiguousarray(elem_dof, dtype=np.int32)
    mat_perm = np.empty(n_ent, dtype=np.int32)
    mat_segids = np.empty(n_ent, dtype=np.int32)
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    indices = np.empty(max(n_ent, 1), dtype=np.int32)
    k_out = ctypes.c_int32(0)
    nnz = library.lib().pfem_ell_pattern(
        _ptr(ed, ctypes.c_int32), E, ns, n_rows, lane_pad,
        _ptr(mat_perm, ctypes.c_int32), _ptr(mat_segids, ctypes.c_int32),
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        ctypes.byref(k_out))
    if nnz < 0:
        return None
    return (mat_perm, mat_segids, indptr, indices[:nnz].copy(),
            int(k_out.value), int(nnz))


def offset_census(elem_dof: np.ndarray, n_rows: int):
    """The distinct diagonal offsets (col - row), ascending int64, over every
    valid pair of element DOF rows (-1 for an eliminated dof).  Raises
    ValueError unless every dof lies in [-1, n_rows) and n_rows fits the
    library's int32."""
    ed = np.asarray(elem_dof)
    if n_rows >= 2**31 - 1 or (ed.dtype != np.int32 and ed.size and (
            ed.min() < -1 or ed.max() >= n_rows)):
        raise ValueError(f"offset census: a dof outside [-1, {n_rows}) "
                         "or n_rows past int32")
    ed = np.ascontiguousarray(ed, dtype=np.int32)
    E, ns = ed.shape
    out = np.empty(max(2 * n_rows - 1, 1), dtype=np.int64)
    n = library.lib().pfem_offset_census(_ptr(ed, ctypes.c_int32), E, ns,
                                          n_rows, _ptr(out, ctypes.c_int64))
    if n < 0:
        raise ValueError(f"offset census: a dof outside [-1, {n_rows})")
    return out[:n].copy()


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
