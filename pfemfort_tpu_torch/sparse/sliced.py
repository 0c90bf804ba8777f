"""Sliced, slot-major ELL: the layout every ELL block takes on its way to
kernel B2 (csrc/ell_spmv.cu).

The padded (N, K) ELL of sparse/formats.py rounds every row up to the
block's longest row, and assembly/pattern.py rounds K up to a multiple of
8 for the TPU's sublane.  A kernel that reads (N, K) reads every padded
slot.  This layout drops that padding:

  * a slice is SLICE = 32 consecutive rows, one warp of the kernel;
  * a slice's width is the largest number of valid slots (column <
    n_cols) among its rows, so no slice is wider than its longest row;
  * within a slice the data is slot-major: slot k of the 32 rows is 32
    consecutive entries, and slice s starts at slice_ptr[s];
  * each row keeps its valid slots in their original slot order, then
    sentinel columns (>= n_cols) for a row shorter than its slice; the
    rows past n_rows in the last slice hold the sentinel n_cols.

Rows keep their order, so y needs no permutation, and each row sums its
products in the order the (N, K) form does (sparse/spmv.py).

The layout depends only on the columns.  `slice_ell` builds it once per
pattern as a SliceLayout, with the flat (N*K) source slot of every sliced
slot; `SliceLayout.pack` then lays out one assembly's values with one
gather, and `SliceLayout.compose` folds an earlier gather (a row
ordering's, the hybrid remainder's) into that one index.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pfemfort_tpu_torch.sparse.formats import ELLMatrix

SLICE = 32


@dataclasses.dataclass(frozen=True)
class SlicedELL:
    """A sparse block in the sliced layout on one device.  `max_width` is
    the widest slice (0 when the block has no valid slot)."""

    cols: torch.Tensor        # (n_slots,) int32; sentinel >= n_cols
    vals: torch.Tensor        # (n_slots,)
    slice_ptr: torch.Tensor   # (n_slices + 1,) int64, multiples of SLICE
    n_rows: int
    n_cols: int
    max_width: int

    @property
    def n_slices(self) -> int:
        return self.slice_ptr.numel() - 1

    @property
    def n_slots(self) -> int:
        return self.cols.numel()


@dataclasses.dataclass(frozen=True)
class SliceLayout:
    """The value-free part of a SlicedELL: its columns, slice pointers and
    the flat source slot of every sliced slot (-1 for a sentinel slot)."""

    cols: torch.Tensor        # (n_slots,) int32
    src: torch.Tensor         # (n_slots,) int64, -1 for a sentinel slot
    slice_ptr: torch.Tensor   # (n_slices + 1,) int64
    n_rows: int
    n_cols: int
    max_width: int

    def pack(self, vals: torch.Tensor) -> SlicedELL:
        """The SlicedELL of one set of values, indexed as `src` indexes
        (flattened): one gather."""
        flat = vals.reshape(-1)
        if flat.numel():
            v = torch.where(self.src >= 0, flat[self.src.clamp(min=0)], 0.0)
        else:
            v = flat.new_zeros(self.src.shape)
        return SlicedELL(cols=self.cols, vals=v, slice_ptr=self.slice_ptr,
                         n_rows=self.n_rows, n_cols=self.n_cols,
                         max_width=self.max_width)

    def compose(self, src: torch.Tensor) -> "SliceLayout":
        """The same layout over values that reach this layout's source
        slots through the flat index `src` (-1 for none)."""
        src = src.reshape(-1)
        keep = self.src >= 0
        return dataclasses.replace(self, src=torch.where(
            keep, src[self.src.clamp(min=0)] if src.numel() else -1, -1))


def slice_ell(cols: torch.Tensor, n_cols: int) -> SliceLayout:
    """Lay an (N, K) column array (sentinel >= n_cols anywhere in a row) out
    as a sliced ELL on cols' device.  Each row is compacted stably: its
    valid slots in slot order, then its own sentinels up to the slice's
    width."""
    N, K = cols.shape
    if N and K and int(cols.max()) >= 2 ** 31:
        raise ValueError("sliced ELL columns must lie below 2**31")
    dev = cols.device
    n_slices = -(-N // SLICE)
    valid = cols < n_cols
    count = torch.zeros(n_slices * SLICE, dtype=torch.int64, device=dev)
    count[:N] = valid.sum(1)
    width = count.view(n_slices, SLICE).amax(1) if n_slices else count
    slice_ptr = torch.zeros(n_slices + 1, dtype=torch.int64, device=dev)
    torch.cumsum(width * SLICE, 0, out=slice_ptr[1:])
    n_slots = int(slice_ptr[-1])

    rows = torch.arange(N, dtype=torch.int64, device=dev)
    base = (slice_ptr[:-1].repeat_interleave(SLICE)[:N]
            + rows % SLICE)[:, None]
    # slot position within the compacted row: valid slots first, then
    # sentinels, each in their original order
    pos = torch.where(valid, valid.cumsum(1) - 1,
                      count[:N, None] + (~valid).cumsum(1) - 1)
    keep = pos < width.repeat_interleave(SLICE)[:N, None]
    dest = (base + pos * SLICE)[keep]
    out_cols = torch.full((n_slots,), n_cols, dtype=torch.int32, device=dev)
    out_src = torch.full((n_slots,), -1, dtype=torch.int64, device=dev)
    out_cols[dest] = cols[keep].to(torch.int32)
    flat = (rows[:, None] * K
            + torch.arange(K, dtype=torch.int64, device=dev)[None, :])
    out_src[dest] = torch.where(valid, flat, -1)[keep]
    return SliceLayout(cols=out_cols, src=out_src, slice_ptr=slice_ptr,
                       n_rows=N, n_cols=int(n_cols),
                       max_width=int(width.max()) if n_slices else 0)


def ell_to_sliced(A: ELLMatrix) -> SlicedELL:
    """A padded ELLMatrix in the sliced layout (layout and pack at once:
    for a block laid out once; per-assembly callers keep the layout)."""
    return slice_ell(A.cols, A.n_cols).pack(A.vals)


def slot_grid(S) -> torch.Tensor:
    """(n_slices, max_width, SLICE) flat slot index of every (slice, slot,
    lane), n_slots past a slice's width: the sliced arrays as dense
    per-slice tiles, for the plain versions."""
    dev = S.slice_ptr.device
    begin = S.slice_ptr[:-1]
    width = (S.slice_ptr[1:] - begin) // SLICE
    k = torch.arange(S.max_width, dtype=torch.int64, device=dev)
    lane = torch.arange(SLICE, dtype=torch.int64, device=dev)
    idx = begin[:, None, None] + k[None, :, None] * SLICE + lane[None, None, :]
    return torch.where(k[None, :, None] < width[:, None, None], idx,
                       S.n_slots)


def unslice(S: SlicedELL) -> ELLMatrix:
    """The (n_rows, max_width) padded ELL of a sliced block, each row's
    slots in the sliced order (for set-up code and checks that read
    rows)."""
    idx = slot_grid(S).permute(0, 2, 1).reshape(
        S.n_slices * SLICE, S.max_width)[:S.n_rows]
    cols = torch.cat([S.cols, S.cols.new_full((1,), S.n_cols)])[idx]
    vals = torch.cat([S.vals, S.vals.new_zeros(1)])[idx]
    return ELLMatrix(cols=cols.contiguous(), vals=vals.contiguous(),
                     n_cols=S.n_cols)


def sliced_slots(cols: np.ndarray, n_cols: int) -> int:
    """Slots the sliced layout of a host (N, K) column array holds: the
    byte count of its product, per value and column, without laying it
    out."""
    count = (np.asarray(cols) < n_cols).sum(axis=1)
    pad = (-len(count)) % SLICE
    count = np.concatenate([count, np.zeros(pad, count.dtype)])
    return int(count.reshape(-1, SLICE).max(axis=1, initial=0).sum()) * SLICE
