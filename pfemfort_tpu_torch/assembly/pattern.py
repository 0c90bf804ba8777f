# Copied from pfemfort_tpu/assembly/pattern.py (no pytree, no JAX-CPU census).
"""Static sparsity pattern + scatter plan (host-side, numpy, built once).

Replacement for the reference's two-pass MatSetValues flow (sparsity
INSERT pre-pass at PFEMFort src/triapoissonparallelimpl1.F:814-825,
ADD_VALUES assembly at :849-905).  Because the mesh is static, the entire
scatter is precomputed host-side; device assembly is one segment-sum
(assembly/assemble.py).

Two layouts:
  * 'dia' (lattice-structured numbering): the distinct diagonal offsets
    (col - row) are detected with an O(nnz) census, no sorting: one pass
    of the host library over each element's dof pairs
    (csrc/host_native.cpp:pfem_offset_census).  Every element entry maps
    to the flat slot d*N + row of a (D, N) diagonal value array.
  * 'ell' (general fallback): unique (row, col) pairs -> CSR -> padded ELL,
    with a stable-sorted scatter plan, built by the host library's
    row-bucket sort (csrc/host_native.cpp:pfem_ell_pattern) or, when an
    index would overflow int32, by one numpy stable argsort; both give the
    same arrays bit for bit.

Dropped contributions (elem_dof == -1, the BC sentinel) map to a trailing
segment, exactly like PETSc's VEC_IGNORE_NEGATIVE_INDICES trick
(PFEMFort src/solverpetsc.F:142-143).
"""

from __future__ import annotations

import dataclasses

from typing import Optional, Tuple

import numpy as np

from pfemfort_tpu_torch import host_native
from pfemfort_tpu_torch.sparse.formats import round_up


@dataclasses.dataclass
class AssemblyPattern:
    layout: str               # 'dia' or 'ell'
    n_rows: int
    # --- rhs scatter (both layouts): unsorted dest ids, sentinel n_rows ---
    rhs_dest: np.ndarray      # (n_elem * ns,)
    # --- 'dia' layout ---
    dia_offsets: Optional[Tuple[int, ...]] = None
    dia_lattice: Optional[Tuple[int, ...]] = None  # stencil fast path
    elem_dof_t: Optional[np.ndarray] = None  # (ns, n_elem) int32, -1 sentinel
    mat_dest: Optional[np.ndarray] = None   # unused in 'dia' (kept for tools)
    # --- 'ell' layout ---
    nnz: int = -1
    indptr: Optional[np.ndarray] = None
    indices: Optional[np.ndarray] = None
    ell_k: int = 0
    ell_cols: Optional[np.ndarray] = None
    mat_perm: Optional[np.ndarray] = None
    mat_segids: Optional[np.ndarray] = None
    mat_nsegs: int = 0

    @property
    def n_offsets(self) -> int:
        return len(self.dia_offsets) if self.dia_offsets else 0


CENSUS_HEAD_ELEMS = 65_536


def _rhs_dest(edt: np.ndarray, n_rows: int):
    """Flat rhs destinations in (i, e) order — matching Fe (ns, E) — from
    the contiguous (ns, E) transpose of elem_dof."""
    dt = np.int32 if n_rows + 1 < 2**31 else np.int64
    return np.where(edt < 0, dt(n_rows), edt.astype(dt, copy=False)).ravel()


def build_pattern(elem_dof: np.ndarray, n_rows: int, lane_pad: int = 8,
                  layout: str = "auto", max_offsets: int = 128,
                  lattice: Optional[Tuple[int, ...]] = None
                  ) -> AssemblyPattern:
    """Build the assembly pattern; 'auto' prefers the O(nnz) DIA census.

    `lattice`: optional row-lattice shape (dofs/dofmap.py:reduced_lattice)
    enabling the N-D stencil SpMV (sparse/dia.py:DIAMatrix.lattice)."""
    elem_dof = np.asarray(elem_dof)
    edt = np.ascontiguousarray(elem_dof.T)        # (ns, E) element-minor
    rhs_dest = _rhs_dest(edt, n_rows)
    if lattice is not None and int(np.prod(lattice)) != n_rows:
        lattice = None

    if layout in ("auto", "dia"):
        # The offsets of the first elements are a subset of all offsets:
        # when they alone exceed max_offsets the whole census would too,
        # so a scrambled mesh skips the full O(nnz) pass.
        uniq = host_native.offset_census(elem_dof[:CENSUS_HEAD_ELEMS], n_rows)
        if len(uniq) <= max_offsets:
            uniq = host_native.offset_census(elem_dof, n_rows)
        if len(uniq) <= max_offsets and len(uniq) > 0:
            return AssemblyPattern(
                layout="dia",
                n_rows=n_rows,
                rhs_dest=rhs_dest,
                dia_offsets=tuple(int(o) for o in uniq),
                dia_lattice=lattice,
                elem_dof_t=edt.astype(np.int32, copy=False),
            )
        if layout == "dia":
            raise ValueError(
                f"{len(uniq)} diagonal offsets exceed max_offsets "
                f"{max_offsets}; pattern is not DIA-structured")

    # ---- general ELL path -------------------------------------------------
    # The host library's row-bucket sort; the numpy builder only where an
    # index would overflow int32 (as in the JAX package).
    res = host_native.ell_pattern(elem_dof, n_rows, lane_pad)
    if res is None:
        return _ell_pattern_numpy(elem_dof, n_rows, lane_pad, rhs_dest)
    mat_perm, mat_segids, indptr, indices, ell_k, nnz = res
    row_deg = np.diff(indptr)
    ell_cols = np.full((n_rows, ell_k), n_rows, dtype=np.int32)
    within = (np.arange(nnz, dtype=np.int64)
              - np.repeat(indptr[:-1], row_deg))
    csr_row = np.repeat(np.arange(n_rows, dtype=np.int64), row_deg)
    ell_cols[csr_row, within] = indices
    return AssemblyPattern(
        layout="ell", n_rows=n_rows, rhs_dest=rhs_dest, nnz=nnz,
        indptr=indptr, indices=indices, ell_k=ell_k, ell_cols=ell_cols,
        mat_perm=mat_perm, mat_segids=mat_segids,
        mat_nsegs=n_rows * ell_k + 1)


def _ell_pattern_numpy(elem_dof: np.ndarray, n_rows: int, lane_pad: int,
                       rhs_dest: np.ndarray) -> AssemblyPattern:
    """The ELL pattern by one numpy stable argsort (the builder of the
    native one's results, kept for patterns past int32 indexing)."""
    # ONE stable (radix) argsort of the packed (row, col) entry keys yields
    # everything in O(nnz) passes: the unique keys (= CSR), the padded-ELL
    # layout, AND the sorted scatter plan.  The ELL-flat destination
    # csr_row * K + within is MONOTONE in key order, so the key sort IS the
    # scatter permutation — no np.unique, no searchsorted, no second argsort.
    ns = elem_dof.shape[1]
    edt = elem_dof.T.astype(np.int64)
    E = edt.shape[1]
    rows = np.broadcast_to(edt[:, None, :], (ns, ns, E)).reshape(-1)
    cols = np.broadcast_to(edt[None, :, :], (ns, ns, E)).reshape(-1)
    sent = n_rows * np.int64(n_rows)
    keys = np.where((rows >= 0) & (cols >= 0), rows * n_rows + cols, sent)
    n_ent = keys.shape[0]
    del rows, cols
    mat_perm = np.argsort(keys, kind="stable")
    ks = keys[mat_perm]
    del keys
    nvalid = int(np.searchsorted(ks, sent))
    ks_v = ks[:nvalid]
    new = np.empty(nvalid, dtype=bool)
    if nvalid:
        new[0] = True
        np.not_equal(ks_v[1:], ks_v[:-1], out=new[1:])
    uk = ks_v[new]
    nnz = len(uk)
    indices = (uk % n_rows).astype(np.int32)
    counts = np.bincount(uk // n_rows, minlength=n_rows)
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])

    row_deg = counts
    ell_k = int(round_up(max(int(row_deg.max(initial=0)), 1), lane_pad))
    ell_cols = np.full((n_rows, ell_k), n_rows, dtype=np.int32)
    within = np.arange(nnz, dtype=np.int64) - np.repeat(indptr[:-1], row_deg)
    csr_row = np.repeat(np.arange(n_rows, dtype=np.int64), row_deg)
    ell_cols[csr_row, within] = indices
    csr_to_ellflat = csr_row * ell_k + within

    dropped_id = n_rows * ell_k
    uidx = np.cumsum(new) - 1                     # sorted entry -> csr rank
    mat_segids = np.full(n_ent, dropped_id, dtype=np.int64)
    mat_segids[:nvalid] = csr_to_ellflat[uidx]

    idx_dtype = np.int32 if n_ent < 2**31 else np.int64
    return AssemblyPattern(
        layout="ell",
        n_rows=n_rows,
        rhs_dest=rhs_dest,
        nnz=nnz,
        indptr=indptr,
        indices=indices,
        ell_k=ell_k,
        ell_cols=ell_cols,
        mat_perm=mat_perm.astype(idx_dtype),
        mat_segids=mat_segids.astype(
            np.int32 if dropped_id + 1 < 2**31 else np.int64),
        mat_nsegs=n_rows * ell_k + 1,
    )
