# Ported from pfemfort_tpu/solve/ic0.py (single device, and the per-rank blocks of build_ic0_shard_blocks).
"""IC(0) preconditioning with truncated-Neumann triangular application.

The reference's serial drivers default to PC=ILU
(PFEMFort src/triapoissonserialimpl1.F:696); its parallel default is
block-Jacobi with one ILU block per rank (solverpetsc.F:206).  Exact
triangular solves are sequential per row, so the application is the
standard wide-vector reformulation:

  * the IC(0) FACTOR L (lower triangular, A ~= L L^T on the pattern of A)
    is computed on the host once per assembly by the host library
    (host_native.py; a failed build raises, there is no Python loop);
  * write L = D (I + T) with T strictly lower.  The APPLICATION uses the
    truncated Neumann series G_m = sum_{k<m} (-T)^k D^{-1} ~= L^{-1}, so one
    preconditioner application is 2(m-1) sparse products with T and T^T;
  * M^{-1} = G_m^T G_m is SPD by construction, so CG remains valid.

T and T^T are stored as padded ELL (sentinel column n) and laid out once,
when a preconditioner is made, in the sliced layout of kernel B2
(sparse/ell_spmv_cuda.py), or routed by solve/amg_device.py.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from pfemfort_tpu_torch import host_native
from pfemfort_tpu_torch.sparse.dia import DIAMatrix
from pfemfort_tpu_torch.sparse.ell_spmv_cuda import ell_spmv
from pfemfort_tpu_torch.sparse.formats import ELLMatrix
from pfemfort_tpu_torch.sparse.sliced import ell_to_sliced
from pfemfort_tpu_torch.utils.timing import count, span


def _csr_from_matrix(A, pattern=None) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray, int]:
    """Host CSR (indptr, indices, float64 vals, n) of a DIA or ELL matrix;
    an ELL matrix needs the pattern it was assembled on.  A DIA matrix's
    rows take every stored entry inside the matrix, its diagonals visited in
    ascending offset order, so each row's columns come out ascending in
    one pass of the host library (no sort)."""
    if isinstance(A, DIAMatrix):
        vals = A.vals.detach().cpu().to(torch.float64).numpy()   # (D, N)
        indptr, indices, v = host_native.dia_to_csr(vals, A.offsets)
        return indptr, indices, v, A.n_rows
    if pattern is None or pattern.layout != "ell":
        raise ValueError("an ELL matrix needs its ELL assembly pattern")
    n = pattern.n_rows
    indptr, indices = pattern.indptr, pattern.indices
    row_deg = np.diff(indptr)
    within = (np.arange(pattern.nnz, dtype=np.int64)
              - np.repeat(indptr[:-1], row_deg))
    csr_row = np.repeat(np.arange(n, dtype=np.int64), row_deg)
    vals = A.vals.detach().cpu().to(torch.float64).numpy()[csr_row, within]
    return indptr, indices.astype(np.int32), vals, n


@dataclasses.dataclass(frozen=True)
class IC0Arrays:
    """The factor's pieces: T and T^T as padded ELL (sentinel n) and
    1/diag(L)."""
    t: ELLMatrix
    tt: ELLMatrix
    dinv: torch.Tensor


def build_ic0_from_csr(indptr, indices, vals, n: int, lane_pad: int = 8,
                       dtype=torch.float32, *, device,
                       timings: Optional[dict] = None) -> IC0Arrays:
    """Factor a host CSR (possibly permuted into the solve's row order) and
    stage T / T^T and 1/diag(L) on `device`, with L = D (I + T).

    `timings`: where the spans go (utils/timing.py, no synchronise of their
    own): ic0.factor_s (L's lower triangle, the host library's factor and
    1/diag(L)) and ic0.layout_s (T and T^T as padded ELL, one pass of the
    host library: T^T holds each column's entries in ascending row order,
    as a stable sort by column would; their copies to `device`); and the
    counter ic0.t_nnz, T's entries."""
    with span("ic0.factor_s", timings):
        lp, li, lv = host_native.csr_lower(indptr, indices, vals, n)
        host_native.ic0(lp, li, lv)
        dinv = 1.0 / lv[lp[1:] - 1]             # diag is last in each row
    with span("ic0.layout_s", timings):
        t_cols, t_vals, tt_cols, tt_vals, t_nnz = host_native.ic0_ell(
            lp, li, lv, dinv, lane_pad)
        ell = lambda c, v: ELLMatrix(
            cols=torch.as_tensor(c, device=device),
            vals=torch.as_tensor(v, dtype=dtype, device=device), n_cols=n)
        arrs = IC0Arrays(t=ell(t_cols, t_vals), tt=ell(tt_cols, tt_vals),
                         dinv=torch.as_tensor(dinv, dtype=dtype,
                                              device=device))
    if timings is not None:
        count("ic0.t_nnz", t_nnz, timings)
    return arrs


def build_ic0_shard_block(cols_local: np.ndarray, vals: np.ndarray,
                          lane_pad: int = 8, dtype=torch.float32, *,
                          device) -> IC0Arrays:
    """IC(0) of one rank's OWN diagonal block: the reference's parallel
    default, PC=BJACOBI with one ILU-class factorization per rank
    (PFEMFort src/solverpetsc.F:206: block-Jacobi whose default sub-PC is
    ILU).  Ghost columns (>= P) are outside the block, exactly PETSc's
    per-rank SeqAIJ diagonal block; a row without a diagonal entry
    (padding) gets a unit pivot.

    cols_local: (P, K) local ELL columns of the rank's rows (sentinel >= P
    outside the block); vals: (P, K) values.  The block's lower CSR goes
    through build_ic0_from_csr (the host library's factor, no size cap)."""
    c = np.asarray(cols_local, dtype=np.int64)
    P = c.shape[0]
    rows = np.arange(P, dtype=np.int64)[:, None]
    lower = (c < P) & (c <= rows)
    miss = np.nonzero(~(lower & (c == rows)).any(axis=1))[0]
    r_idx, k_idx = np.nonzero(lower)
    rr = np.concatenate([r_idx, miss])
    cc = np.concatenate([c[r_idx, k_idx], miss])
    vv = np.concatenate([np.asarray(vals, dtype=np.float64)[r_idx, k_idx],
                         np.ones(len(miss))])
    order = np.lexsort((cc, rr))
    indptr = np.zeros(P + 1, dtype=np.int64)
    np.cumsum(np.bincount(rr, minlength=P), out=indptr[1:])
    return build_ic0_from_csr(indptr, cc[order], vv[order], P, lane_pad,
                              dtype, device=device)


def ic0_apply(t_mv: Callable, tt_mv: Callable, dinv: torch.Tensor,
              m: int = 4) -> Callable:
    """r -> G_m^T G_m r for the products x -> T x and x -> T^T x."""
    def apply(r):
        rd = dinv * r
        z = rd
        for _ in range(m - 1):                 # z ~= (I+T)^{-1} D^{-1} r
            z = rd - t_mv(z)
        w = z
        for _ in range(m - 1):                 # w ~= (I+T^T)^{-1} z
            w = z - tt_mv(w)
        return dinv * w

    return apply


def ic0_preconditioner(arrs: IC0Arrays, m: int = 4) -> Callable:
    """r -> G_m^T G_m r (SPD; 2(m-1) ELL products per application)."""
    t, tt = ell_to_sliced(arrs.t), ell_to_sliced(arrs.tt)
    return ic0_apply(lambda x: ell_spmv(t, x), lambda x: ell_spmv(tt, x),
                     arrs.dinv, m)
