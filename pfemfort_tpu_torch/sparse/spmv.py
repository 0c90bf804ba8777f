# Ported from pfemfort_tpu/sparse/spmv.py (spmv_ell, extract_diagonal).
"""Plain PyTorch ELL SpMV and diagonal, in both layouts.

`spmv_sliced` is the CPU path of kernel B2 (sparse/ell_spmv_cuda.py) and
the oracle the kernel is held against on the card; `spmv_ell` on the padded
(N, K) form is the JAX package's function, kept as the parity oracle.  Both
add each row's products in slot order, one slot after another, as the
kernel does, so a row gives the same bits in either layout.  This replaces
the reference's PETSc MatMult inside KSPSolve (PFEMFort
src/solverpetsc.F:476).
"""

from __future__ import annotations

import torch

from pfemfort_tpu_torch.sparse.formats import ELLMatrix
from pfemfort_tpu_torch.sparse.sliced import SLICE, SlicedELL, slot_grid


def _sum_in_slot_order(terms: torch.Tensor) -> torch.Tensor:
    """Sum over dim 1, slot 0 first, one slot at a time."""
    acc = terms.new_zeros((terms.shape[0],) + tuple(terms.shape[2:]))
    for k in range(terms.shape[1]):
        acc = acc + terms[:, k]
    return acc


def spmv_ell(A: ELLMatrix, x: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_k vals[i,k] * x[cols[i,k]]; a sentinel column >= n_cols
    reads a zero slot.

    JAX clamps an out-of-range gather index onto its zero slot; a torch
    index raises instead, so the columns are clamped here explicitly."""
    xp = torch.cat([x, x.new_zeros(1)])
    return _sum_in_slot_order(A.vals * xp[A.cols.clamp(max=A.n_cols).long()])


def _sliced_row_sums(S: SlicedELL, per_slot: torch.Tensor) -> torch.Tensor:
    """Each row's sum of a per-slot quantity, in slot order."""
    tiles = torch.cat([per_slot, per_slot.new_zeros(1)])[slot_grid(S)]
    return _sum_in_slot_order(tiles).reshape(-1)[:S.n_rows]


def spmv_sliced(S: SlicedELL, x: torch.Tensor) -> torch.Tensor:
    """y = A x for a sliced ELL block (sparse/sliced.py)."""
    xp = torch.cat([x, x.new_zeros(1)])
    return _sliced_row_sums(S, S.vals * xp[S.cols.clamp(max=S.n_cols).long()])


def extract_diagonal(A: ELLMatrix) -> torch.Tensor:
    """diag(A) from ELL: the slot whose column equals the row id."""
    rows = torch.arange(A.n_rows, dtype=A.cols.dtype,
                        device=A.cols.device)[:, None]
    return torch.where(A.cols == rows, A.vals, 0).sum(dim=1)


def sliced_diagonal(S: SlicedELL) -> torch.Tensor:
    """diag(A) of a sliced block: the slot whose column equals its row."""
    dev = S.cols.device
    width = (S.slice_ptr[1:] - S.slice_ptr[:-1]) // SLICE
    first_row = torch.arange(S.n_slices, dtype=torch.int64,
                             device=dev) * SLICE
    row = (first_row.repeat_interleave(width * SLICE)
           + torch.arange(S.n_slots, dtype=torch.int64, device=dev) % SLICE)
    return _sliced_row_sums(S, torch.where(S.cols == row, S.vals, 0))
