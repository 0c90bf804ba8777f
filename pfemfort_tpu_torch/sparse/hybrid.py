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
  * A_rem: everything else, as an (N, K_rem) padded-ELL block for B2.

Both parts read the same x; y = y_dia + y_rem.  The split is a host plan of
flat source indices into the assembled (N, K) ELL values, so each assembly
packs both parts with one device gather each.  The JAX package packed the
remainder into its TPU slot-gather layout; on the card B2 reads the (N,
K_rem) block as it is, so that plan, its V caps and its support gate are
not carried over.

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
from pfemfort_tpu_torch.sparse.formats import ELLMatrix
from pfemfort_tpu_torch.sparse.ordering import permuted_sorted_cols
from pfemfort_tpu_torch.sparse.spmv import extract_diagonal


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
    N, K = cols.shape
    rows2d = np.arange(N, dtype=np.int64)[:, None]
    valid = cols < n_rows
    off = np.where(valid, cols - rows2d, 0)
    shift = n_rows - 1
    cnt = np.bincount((off + shift).ravel()[valid.ravel()],
                      minlength=2 * n_rows - 1)

    thresh = max(int(fill_threshold * N), 1)
    cand = np.nonzero(cnt >= thresh)[0]
    if len(cand) > max_d:
        cand = cand[np.argsort(cnt[cand], kind="stable")[::-1][:max_d]]
    offsets = tuple(int(o) for o in np.sort(cand - shift))
    D = len(offsets)

    off2d = np.full(2 * n_rows - 1, -1, dtype=np.int32)
    off2d[np.asarray(offsets, np.int64) + shift] = np.arange(
        D, dtype=np.int32)
    d_idx = np.where(valid, off2d[off + shift], -1)
    in_dia = d_idx >= 0

    dia_src = np.full((D, n_rows), -1, dtype=np.int64)
    rr = np.broadcast_to(rows2d, (N, K))
    dia_src[d_idx[in_dia], rr[in_dia]] = src_of_slot[in_dia]
    nnz_dia = int(in_dia.sum())

    rem = valid & ~in_dia
    nnz_rem = int(rem.sum())
    rem_cols = rem_src = None
    if nnz_rem:
        k_rem = int(rem.sum(axis=1).max(initial=1))
        rem_cols = np.full((N, k_rem), n_rows, dtype=np.int64)
        rem_src = np.full((N, k_rem), -1, dtype=np.int64)
        within = np.cumsum(rem, axis=1) - 1
        rws, w = rr[rem], within[rem]
        rem_cols[rws, w] = cols[rem]
        rem_src[rws, w] = src_of_slot[rem]

    return HybridPlan(n_rows=n_rows, offsets=offsets, dia_src=dia_src,
                      rem_cols=rem_cols, rem_src=rem_src, nnz_dia=nnz_dia,
                      nnz_rem=nnz_rem)


def plan_bytes(plan: HybridPlan, value_bytes: int) -> int:
    """Bytes one product reads from the two blocks (values, plus the
    remainder's int32 columns)."""
    return plan.n_rows * (plan.D * value_bytes
                          + plan.k_rem * (value_bytes + 4))


# ---------------------------------------------------------------------------
# reference executor (numpy; validates the split on the CPU)
# ---------------------------------------------------------------------------

def apply_hybrid_reference(plan: HybridPlan, vals: np.ndarray,
                           x: np.ndarray) -> np.ndarray:
    """y = A_p x from the plan arrays alone.  `vals`: UN-permuted (N, K)
    ELL values; `x` lives in the plan's (permuted) row space."""
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
        y = y + (rv * xp[np.minimum(plan.rem_cols, plan.n_rows)]).sum(1)
    return y


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HybridMatrix:
    """The two blocks of a hybrid operator on one device: a DIA block for
    kernel B1 (None when no diagonal passed the threshold) and a square ELL
    remainder for kernel B2 (None when it is empty)."""
    n_rows: int
    dia: Optional[DIAMatrix]
    dia_offsets: Optional[torch.Tensor]   # int32, A.offsets on the device
    rem: Optional[ELLMatrix]

    def diagonal(self) -> torch.Tensor:
        """diag(A): the main diagonal is always extracted when the plan
        has one (it is 100% full); otherwise read from the remainder."""
        if self.dia is not None and 0 in self.dia.offsets:
            return self.dia.vals[self.dia.offsets.index(0)]
        return extract_diagonal(self.rem)


@dataclasses.dataclass(frozen=True)
class HybridLayout:
    """A plan's index arrays on the device: `pack` turns each assembly's
    (N, K) ELL values into a HybridMatrix with one gather per part."""
    n_rows: int
    offsets: Tuple[int, ...]
    dia_offsets: Optional[torch.Tensor]
    dia_src: Optional[torch.Tensor]      # (D, N) int64, -1 empty
    rem_cols: Optional[torch.Tensor]     # (N, K_rem) int32
    rem_src: Optional[torch.Tensor]      # (N, K_rem) int64, -1 empty

    def pack(self, vals: torch.Tensor) -> HybridMatrix:
        flat = vals.reshape(-1)
        take = lambda src: torch.where(src >= 0, flat[src.clamp(min=0)],
                                       0.0)
        dia = rem = None
        if self.dia_src is not None:
            dia = DIAMatrix(vals=take(self.dia_src), offsets=self.offsets,
                            n_rows=self.n_rows)
        if self.rem_cols is not None:
            rem = ELLMatrix(cols=self.rem_cols, vals=take(self.rem_src),
                            n_cols=self.n_rows)
        return HybridMatrix(n_rows=self.n_rows, dia=dia,
                            dia_offsets=self.dia_offsets, rem=rem)


def hybrid_layout(plan: HybridPlan, device) -> HybridLayout:
    """Lay a plan's index arrays out on `device`, once per pattern."""
    device = torch.device(device)
    as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    has_dia = plan.D > 0
    return HybridLayout(
        n_rows=plan.n_rows, offsets=plan.offsets,
        dia_offsets=as_t(plan.offsets, torch.int32) if has_dia else None,
        dia_src=as_t(plan.dia_src, torch.int64) if has_dia else None,
        rem_cols=(None if plan.rem_cols is None
                  else as_t(plan.rem_cols, torch.int32)),
        rem_src=(None if plan.rem_src is None
                 else as_t(plan.rem_src, torch.int64)))


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
        y = dia_spmv(H.dia, x, H.dia_offsets)
    if H.rem is not None:
        y_rem = ell_spmv(H.rem, x)
        y = y_rem if y is None else y + y_rem
    return torch.zeros_like(x) if y is None else y
