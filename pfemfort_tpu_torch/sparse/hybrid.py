# Ported from pfemfort_tpu/sparse/hybrid.py (the plan; the remainder as plain ELL).
"""Hybrid DIA + ELL SpMV: the dense diagonals of an ordered ELL system
through kernel B1, the rest through kernel B2.

After a bandwidth-reducing row ordering most FEM nonzeros sit on a few
dense diagonals: on a scrambled generator lattice the geometric-lex order
recovers the stencil exactly (every nonzero on one of 15 diagonals), and
irregular meshes still put a large share of their entries on the main
diagonals.  So split, once per sparsity pattern:

    A  =  A_dia  +  A_rem

  * A_dia: every diagonal that at least `fill_threshold` of the rows
    populate (at most `max_d` of them), as a (D, N) DIA block — B1 reads
    no column indices;
  * A_rem: everything else, as an (N, K_rem) padded-ELL block in the host
    plan, laid out on the device in B2's sliced layout (sparse/sliced.py).

Both parts read the same x; y = y_dia + y_rem.  (A rank of the distributed
ELL route splits its own block the same way, parallel/dist_ell.py: there
the remainder also holds the ghost columns and reads the ghost-extended x,
while the DIA part reads the rank's own.)  The split is a host plan of
flat source indices into the assembled (N, K) ELL values, so each assembly
packs both parts with one device gather each.  The JAX package packed the
remainder into its TPU slot-gather layout; on the card B2 reads it sliced,
so that plan, its V caps and its support gate are not carried over.

Replaces the hot loop of the reference's format-agnostic PETSc MatMult
(PFEMFort src/solverpetsc.F:476) for unstructured meshes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from pfemfort_tpu_torch.sparse.dia import DIAMatrix
from pfemfort_tpu_torch.sparse.dia_spmv_cuda import dia_spmv
from pfemfort_tpu_torch.sparse.ell_spmv_cuda import ell_spmv
from pfemfort_tpu_torch.sparse.ordering import permuted_sorted_cols
from pfemfort_tpu_torch.sparse.sliced import SliceLayout, SlicedELL, \
    slice_ell, sliced_slots
from pfemfort_tpu_torch.sparse.spmv import sliced_diagonal


# ---------------------------------------------------------------------------
# host-side plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HybridPlan:
    """Static split of an ELL pattern into dense diagonals + remainder,
    in the plan's (permuted) row space."""
    n_rows: int
    offsets: Tuple[int, ...]       # extracted diagonals
    dia_src: np.ndarray            # (D, n_rows) int64 flat index into the
    #                                UN-permuted (N*K) values, or -1
    rem_cols: Optional[np.ndarray]  # (N, K_rem) int64, sentinel n_rows;
    #                                 None when the remainder is empty
    rem_src: Optional[np.ndarray]  # (N, K_rem) int64 flat source, or -1
    nnz_dia: int = 0
    nnz_rem: int = 0
    n_cols: Optional[int] = None   # the remainder's columns (and sentinel);
    #                                None: n_rows (a square system)

    @property
    def rem_n_cols(self) -> int:
        return self.n_rows if self.n_cols is None else self.n_cols

    @property
    def D(self) -> int:
        return len(self.offsets)

    @property
    def k_rem(self) -> int:
        return 0 if self.rem_cols is None else self.rem_cols.shape[1]


def build_hybrid_plan(ell_cols: np.ndarray, n_rows: int,
                      order: Optional[np.ndarray] = None,
                      fill_threshold: float = 0.2,
                      max_d: int = 48) -> HybridPlan:
    """Split the (ordered) pattern by per-diagonal fill.

    `fill_threshold`: the least fraction of rows a diagonal must populate
    to be extracted (the JAX package's value; the most filled `max_d`
    diagonals are kept when more pass)."""
    cols, src_of_slot, _ = permuted_sorted_cols(ell_cols, n_rows, order,
                                                n_rows)
    return split_sorted(cols, src_of_slot, n_rows, fill_threshold, max_d)


def split_sorted(cols: np.ndarray, src_of_slot: np.ndarray, n_rows: int,
                 fill_threshold: float = 0.2,
                 max_d: int = 48) -> HybridPlan:
    """`build_hybrid_plan` from the permuted columns and their sources
    (sparse/ordering.py:permuted_sorted_cols), for callers that have
    them."""
    offsets = dense_offsets(diagonal_counts(cols, n_rows), len(cols),
                            fill_threshold, max_d)
    return split_on_offsets(cols, src_of_slot, n_rows, offsets)


def diagonal_counts(cols: np.ndarray, n_rows: int) -> np.ndarray:
    """(2 n_rows - 1,) int64: the slots of an (n_rows, K) column array
    whose column lies below n_rows, by diagonal c - r + n_rows - 1."""
    rows2d = np.arange(cols.shape[0], dtype=np.int64)[:, None]
    valid = cols < n_rows
    off = np.where(valid, cols - rows2d, 0)
    return np.bincount((off + n_rows - 1).ravel()[valid.ravel()],
                       minlength=2 * n_rows - 1)


def dense_offsets(counts: np.ndarray, rows: int, fill_threshold: float = 0.2,
                  max_d: int = 48) -> Tuple[int, ...]:
    """The diagonals that at least `fill_threshold` of `rows` rows populate,
    from per-diagonal counts indexed as `diagonal_counts` indexes them: the
    `max_d` most filled when more pass (ties broken as the JAX package's
    stable argsort breaks them), in ascending order."""
    counts = np.asarray(counts)
    thresh = max(int(fill_threshold * rows), 1)
    cand = np.nonzero(counts >= thresh)[0]
    if len(cand) > max_d:
        cand = cand[np.argsort(counts[cand], kind="stable")[::-1][:max_d]]
    return tuple(int(o) for o in np.sort(cand - (len(counts) - 1) // 2))


def split_on_offsets(cols: np.ndarray, src_of_slot: np.ndarray, n_rows: int,
                     offsets: Tuple[int, ...],
                     n_cols: Optional[int] = None) -> HybridPlan:
    """Split an (n_rows, K) column array on the given diagonals: the slots
    whose column lies below n_rows on one of `offsets` go to the DIA block,
    every other slot below `n_cols` (default n_rows; a wider block's extra
    columns are never on a diagonal) to the remainder, sentinel n_cols."""
    N, K = cols.shape
    n_cols = n_rows if n_cols is None else int(n_cols)
    rows2d = np.arange(N, dtype=np.int64)[:, None]
    own = cols < n_rows
    off = np.where(own, cols - rows2d, 0)
    shift = n_rows - 1
    D = len(offsets)

    off2d = np.full(2 * n_rows - 1, -1, dtype=np.int32)
    off2d[np.asarray(offsets, np.int64) + shift] = np.arange(
        D, dtype=np.int32)
    d_idx = np.where(own, off2d[off + shift], -1)
    in_dia = d_idx >= 0

    dia_src = np.full((D, n_rows), -1, dtype=np.int64)
    rr = np.broadcast_to(rows2d, (N, K))
    dia_src[d_idx[in_dia], rr[in_dia]] = src_of_slot[in_dia]
    nnz_dia = int(in_dia.sum())

    rem = (cols < n_cols) & ~in_dia
    nnz_rem = int(rem.sum())
    rem_cols = rem_src = None
    if nnz_rem:
        k_rem = int(rem.sum(axis=1).max(initial=1))
        rem_cols = np.full((N, k_rem), n_cols, dtype=np.int64)
        rem_src = np.full((N, k_rem), -1, dtype=np.int64)
        within = np.cumsum(rem, axis=1) - 1
        rws, w = rr[rem], within[rem]
        rem_cols[rws, w] = cols[rem]
        rem_src[rws, w] = src_of_slot[rem]

    return HybridPlan(n_rows=n_rows, offsets=tuple(offsets), dia_src=dia_src,
                      rem_cols=rem_cols, rem_src=rem_src, nnz_dia=nnz_dia,
                      nnz_rem=nnz_rem,
                      n_cols=None if n_cols == n_rows else n_cols)


def plan_bytes(plan: HybridPlan, value_bytes: int) -> int:
    """Bytes one product reads from the two blocks: the diagonals' values,
    and the sliced remainder's values and int32 columns."""
    rem = 0 if plan.rem_cols is None else sliced_slots(plan.rem_cols,
                                                       plan.rem_n_cols)
    return plan.n_rows * plan.D * value_bytes + rem * (value_bytes + 4)


# ---------------------------------------------------------------------------
# reference executor (numpy; validates the split on the CPU)
# ---------------------------------------------------------------------------

def apply_hybrid_reference(plan: HybridPlan, vals: np.ndarray,
                           x: np.ndarray) -> np.ndarray:
    """y = A_p x from the plan arrays alone.  `vals`: UN-permuted (N, K)
    ELL values; `x` lives in the plan's (permuted) row space, with the
    remainder's extra columns after its rows when the plan has any."""
    flat = np.asarray(vals).reshape(-1)
    y = np.zeros(plan.n_rows, dtype=x.dtype)
    for d, o in enumerate(plan.offsets):
        src = plan.dia_src[d]
        rr = np.nonzero(src >= 0)[0]
        y[rr] += flat[src[rr]] * x[rr + o]
    if plan.rem_cols is not None:
        ok = plan.rem_src >= 0
        rv = np.where(ok, flat[np.clip(plan.rem_src, 0, None)], 0.0)
        xp = np.concatenate([x, np.zeros(1, x.dtype)])
        y = y + (rv * xp[np.minimum(plan.rem_cols, plan.rem_n_cols)]).sum(1)
    return y


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HybridMatrix:
    """The two blocks of a hybrid operator on one device: a DIA block for
    kernel B1 (None when no diagonal passed the threshold) and a sliced ELL
    remainder for kernel B2 (None when it is empty).  The remainder is
    square on one device; a rank's remainder (parallel/dist_ell.py) also
    reads its ghost columns, past n_rows."""
    n_rows: int
    dia: Optional[DIAMatrix]
    rem: Optional[SlicedELL]

    def diagonal(self) -> torch.Tensor:
        """diag(A): the main diagonal is always extracted when the plan
        has one (it is 100% full); otherwise read from the remainder."""
        if self.dia is not None and 0 in self.dia.offsets:
            return self.dia.vals[self.dia.offsets.index(0)]
        return sliced_diagonal(self.rem)


@dataclasses.dataclass(frozen=True)
class HybridLayout:
    """A plan's index arrays on the device: `pack` turns each assembly's
    (N, K) ELL values into a HybridMatrix with one gather per part."""
    n_rows: int
    offsets: Tuple[int, ...]
    dia_src: Optional[torch.Tensor]      # (D, N) int64, -1 empty
    rem: Optional[SliceLayout]           # sliced, sourced from the values

    def pack(self, vals: torch.Tensor) -> HybridMatrix:
        flat = vals.reshape(-1)
        dia = None
        if self.dia_src is not None:
            dia = DIAMatrix(vals=torch.where(self.dia_src >= 0,
                                             flat[self.dia_src.clamp(min=0)],
                                             0.0),
                            offsets=self.offsets, n_rows=self.n_rows)
        return HybridMatrix(
            n_rows=self.n_rows, dia=dia, rem=None if self.rem is None else self.rem.pack(flat))


def hybrid_layout(plan: HybridPlan, device) -> HybridLayout:
    """Lay a plan's index arrays out on `device`, once per pattern: the
    remainder sliced over its n_cols columns, its sources composed with
    the plan's rem_src."""
    device = torch.device(device)
    as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    has_dia = plan.D > 0
    rem = None
    if plan.rem_cols is not None:
        rem = slice_ell(as_t(plan.rem_cols, torch.int64),
                        plan.rem_n_cols).compose(as_t(plan.rem_src,
                                                      torch.int64))
    return HybridLayout(
        n_rows=plan.n_rows, offsets=plan.offsets,
        dia_src=as_t(plan.dia_src, torch.int64) if has_dia else None,
        rem=rem)


def hybrid_from_plan(plan: HybridPlan, vals: np.ndarray, dtype,
                     device) -> HybridMatrix:
    """A HybridMatrix of fixed host values (N, K) on `device`."""
    return hybrid_layout(plan, device).pack(
        torch.as_tensor(vals, dtype=dtype, device=device))


def apply_hybrid(H: HybridMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x in the plan's row space: B1 on the dense diagonals plus B2
    on the remainder, on the same x (each wrapper takes its plain version
    on a CPU tensor)."""
    y = None
    if H.dia is not None:
        y = dia_spmv(H.dia, x)
    if H.rem is not None:
        y_rem = ell_spmv(H.rem, x)
        y = y_rem if y is None else y + y_rem
    return torch.zeros_like(x) if y is None else y
