# Ported from pfemfort_tpu/sparse/ops.py.
"""Operator interface over the DIA and ELL formats.

Every SpMV of a solve goes through a kernel wrapper: sparse/dia_spmv_cuda.py
(kernel B1) for a DIAMatrix, sparse/ell_spmv_cuda.py (kernel B2) for an
ELLMatrix.  Each launches its hand-written CUDA kernel for CUDA tensors and
takes its plain version for CPU tensors.  There is no size gate and no
switch that routes around a kernel.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import torch

from pfemfort_tpu_torch.sparse.dia import DIAMatrix, dia_diagonal
from pfemfort_tpu_torch.sparse.dia_spmv_cuda import dia_spmv
from pfemfort_tpu_torch.sparse.ell_spmv_cuda import ell_spmv
from pfemfort_tpu_torch.sparse.formats import ELLMatrix
from pfemfort_tpu_torch.sparse.spmv import extract_diagonal

Matrix = Union[DIAMatrix, ELLMatrix]


def dia_operator(A: DIAMatrix) -> Callable:
    """x -> A x.  Call this OUTSIDE any iteration loop: it copies the
    offsets to A's device once."""
    offsets = torch.tensor(A.offsets, dtype=torch.int32,
                           device=A.vals.device)
    return lambda x: dia_spmv(A, x, offsets)


def operator_and_diag(A: Matrix) -> Tuple[Callable, torch.Tensor]:
    """(x -> A x, diag(A)) for either sparse format."""
    if isinstance(A, DIAMatrix):
        return dia_operator(A), dia_diagonal(A)
    return (lambda x: ell_spmv(A, x)), extract_diagonal(A)
