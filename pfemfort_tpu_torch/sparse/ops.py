# Ported from pfemfort_tpu/sparse/ops.py (the DIA half).
"""Operator interface over the DIA format.

Every SpMV of a solve goes through sparse/dia_spmv_cuda.py:dia_spmv: the
hand-written CUDA kernel for CUDA tensors, the plain version for CPU
tensors.  There is no size gate and no switch that routes around the
kernel.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from pfemfort_tpu_torch.sparse.dia import DIAMatrix, dia_diagonal
from pfemfort_tpu_torch.sparse.dia_spmv_cuda import dia_spmv


def dia_operator(A: DIAMatrix) -> Callable:
    """x -> A x.  Call this OUTSIDE any iteration loop: it copies the
    offsets to A's device once."""
    offsets = torch.tensor(A.offsets, dtype=torch.int32,
                           device=A.vals.device)
    return lambda x: dia_spmv(A, x, offsets)


def operator_and_diag(A: DIAMatrix) -> Tuple[Callable, torch.Tensor]:
    """(x -> A x, diag(A))."""
    if not isinstance(A, DIAMatrix):
        raise NotImplementedError(
            "only DIAMatrix is ported; the ELL format waits for ROADMAP A.4")
    return dia_operator(A), dia_diagonal(A)
