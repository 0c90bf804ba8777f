# Ported from pfemfort_tpu/sparse/spmv.py (spmv_ell, extract_diagonal).
"""Plain PyTorch ELL SpMV and diagonal.

`spmv_ell` is the CPU path and the oracle the hand-written CUDA kernel
(sparse/ell_spmv_cuda.py) is held against.  This replaces the reference's
PETSc MatMult inside KSPSolve (PFEMFort src/solverpetsc.F:476).
"""

from __future__ import annotations

import torch

from pfemfort_tpu_torch.sparse.formats import ELLMatrix


def spmv_ell(A: ELLMatrix, x: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_k vals[i,k] * x[cols[i,k]]; a sentinel column >= n_cols
    reads a zero slot.

    JAX clamps an out-of-range gather index onto its zero slot; a torch
    index raises instead, so the columns are clamped here explicitly."""
    xp = torch.cat([x, x.new_zeros(1)])
    return (A.vals * xp[A.cols.clamp(max=A.n_cols).long()]).sum(dim=1)


def extract_diagonal(A: ELLMatrix) -> torch.Tensor:
    """diag(A) from ELL: the slot whose column equals the row id."""
    rows = torch.arange(A.n_rows, dtype=A.cols.dtype,
                        device=A.cols.device)[:, None]
    return torch.where(A.cols == rows, A.vals, 0).sum(dim=1)
