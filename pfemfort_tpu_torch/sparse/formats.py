# Ported from pfemfort_tpu/sparse/formats.py.
"""Padded-ELL sparse matrix container.

Every row stores exactly K column/value slots (K = max row degree, rounded
up).  FEM meshes have tightly bounded node degree (~7 in 2D, ~15 for the
6-tet split), so padding waste is small and every SpMV is a dense (N, K)
gather-multiply-reduce instead of the reference's PETSc MPIAIJ CSR
(PFEMFort src/solverpetsc.F:152-166).

Columns are non-negative.  A padded slot holds a sentinel column >= n_cols
(n_cols itself from the pattern builder, 2 * n_rows + 128 after a row
ordering, sparse/ordering.py:permuted_sorted_cols) and a zero value; it
adds nothing to a product.

This (N, K) form is what assembly writes and set-up reads.  A product on
it goes through kernel B2, which takes the block laid out once in the
sliced layout of sparse/sliced.py, without the padding.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ELLMatrix:
    """Padded ELL sparse matrix: cols (N, K) int32, vals (N, K) on one
    device.  `n_cols` is the length of the x it multiplies (n_rows for a
    square system, more for a rectangular block)."""

    cols: torch.Tensor   # (n_rows, K) int32; padded entries >= n_cols
    vals: torch.Tensor   # (n_rows, K)
    n_cols: int

    @property
    def n_rows(self) -> int:
        return self.cols.shape[0]

    @property
    def k(self) -> int:
        return self.cols.shape[1]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
