# Copied from pfemfort_tpu/sparse/slotgather.py (rcm_order, coord_lex_order, permuted_sorted_cols).
"""Row orderings for ELL systems and the permuted column layout.

A bandwidth-reducing row ordering makes an FEM matrix banded, so the rows a
thread block of the ELL SpMV kernel owns read x from a narrow window (cache
lines shared between neighbouring rows).  Solve in the permuted space:
permute b once, un-permute u once — never per iteration.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# Sentinel column of a padded slot after a row ordering: 2 * n_rows + LANES
# (the TPU lane width the JAX package's plan builder used; kept so that both
# packages produce the same column arrays).
LANES = 128


def rcm_order(indptr: np.ndarray, indices: np.ndarray,
              n_rows: int) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of the pattern graph (scipy)."""
    import scipy.sparse as ssp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    A = ssp.csr_matrix((np.ones(len(indices), np.float32),
                        indices, indptr), shape=(n_rows, n_rows))
    return np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True),
                      dtype=np.int64)


def coord_lex_order(coords_rows: np.ndarray,
                    comp: Optional[np.ndarray] = None) -> np.ndarray:
    """Geometric (z, y, x[, dof]) lexicographic row ordering.

    For meshes whose nodes lie on (or near) a lattice this recovers the
    banded numbering exactly; RCM stays the fallback for meshes where
    geometry is a poor bandwidth proxy.  `comp`: per-row dof component
    (keeps a node's rows adjacent)."""
    # np.lexsort: LAST key is primary -> (comp, x, y, z) sorts by z, y, x
    # with the dof component fastest-varying (node rows stay adjacent)
    keys = [coords_rows[:, d] for d in range(coords_rows.shape[1])]
    if comp is not None:
        keys.insert(0, comp)
    return np.lexsort(tuple(keys)).astype(np.int64)


def permuted_sorted_cols(ell_cols: np.ndarray, n_rows: int,
                         order: Optional[np.ndarray], n_cols: int):
    """Apply the row ordering to rows AND columns, sort slots ascending per
    row (sentinels last), and track each slot's flat source index into the
    UN-permuted (N, K) value array.  Returns (cols (N, K) int64,
    src_of_slot (N, K) int64, inv)."""
    N, K = ell_cols.shape
    cols = ell_cols.astype(np.int64)
    inv = None
    if order is not None:
        if n_cols != n_rows:
            raise ValueError("order requires a square system")
        inv = np.empty(N, np.int64)
        inv[order] = np.arange(N)
        sent = cols >= n_rows
        cols = np.where(sent, 2 * n_rows + LANES,
                        inv[np.clip(cols, 0, N - 1)])
        cols = cols[order]
        slot_order = np.argsort(cols, axis=1, kind="stable")
        cols = np.take_along_axis(cols, slot_order, axis=1)
        src_of_slot = (order[:, None] * K + slot_order)
    else:
        # sort slots per row (ghost-extended local ids are not ascending)
        slot_order = np.argsort(cols, axis=1, kind="stable")
        cols = np.take_along_axis(cols, slot_order, axis=1)
        src_of_slot = (np.arange(N, dtype=np.int64)[:, None] * K
                       + slot_order)
    return cols, src_of_slot, inv
