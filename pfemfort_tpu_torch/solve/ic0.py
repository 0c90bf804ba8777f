# Ported from pfemfort_tpu/solve/ic0.py (single device).
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
from typing import Callable, Tuple

import numpy as np
import torch

from pfemfort_tpu_torch import host_native
from pfemfort_tpu_torch.sparse.dia import DIAMatrix
from pfemfort_tpu_torch.sparse.ell_spmv_cuda import ell_spmv
from pfemfort_tpu_torch.sparse.formats import ELLMatrix, round_up
from pfemfort_tpu_torch.sparse.sliced import ell_to_sliced


def _csr_from_matrix(A, pattern=None) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray, int]:
    """Host CSR (indptr, indices, float64 vals, n) of a DIA or ELL matrix;
    an ELL matrix needs the pattern it was assembled on."""
    if isinstance(A, DIAMatrix):
        n = A.n_rows
        vals = A.vals.detach().cpu().to(torch.float64).numpy()   # (D, N)
        rows_l, cols_l, vals_l = [], [], []
        r = np.arange(n, dtype=np.int64)
        for d, o in enumerate(A.offsets):
            c = r + o
            ok = (c >= 0) & (c < n)
            rows_l.append(r[ok])
            cols_l.append(c[ok])
            vals_l.append(vals[d, ok])
        rows = np.concatenate(rows_l)
        cols = np.concatenate(cols_l)
        v = np.concatenate(vals_l)
        order = np.lexsort((cols, rows))
        rows, cols, v = rows[order], cols[order], v[order]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
        return indptr, cols.astype(np.int32), v, n
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


def _to_ell(r, c, v, n: int, lane_pad: int):
    deg = np.bincount(r, minlength=n)
    K = int(round_up(max(int(deg.max(initial=0)), 1), lane_pad))
    start = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=start[1:])
    within = np.arange(len(r), dtype=np.int64) - start[r]
    cols = np.full((n, K), n, dtype=np.int32)
    vals = np.zeros((n, K), dtype=np.float64)
    cols[r, within] = c
    vals[r, within] = v
    return cols, vals


def ic0_factor_csr(indptr, indices, vals, n: int):
    """Factor on the host: (t_rows, t_cols, t_vals, dinv) of the strictly
    lower T = D^{-1} L - I and 1/diag(L), all numpy."""
    lower = indices <= np.repeat(np.arange(n, dtype=np.int64),
                                 np.diff(indptr))
    li = np.ascontiguousarray(indices[lower], dtype=np.int32)
    lv = np.ascontiguousarray(vals[lower], dtype=np.float64)
    lp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(
        np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))[lower],
        minlength=n), out=lp[1:])
    host_native.ic0(lp, li, lv)

    # L = D (I + T): T[i, j] = L[i, j] / L[i, i] for j < i
    diag = lv[lp[1:] - 1]                       # diag is last in each row
    dinv = 1.0 / diag
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(lp))
    strict = li < rows
    tr, tc = rows[strict], li[strict].astype(np.int64)
    return tr, tc, lv[strict] * dinv[tr], dinv


def build_ic0_from_csr(indptr, indices, vals, n: int, lane_pad: int = 8,
                       dtype=torch.float32, *, device) -> IC0Arrays:
    """Factor a host CSR (possibly permuted into the solve's row order) and
    stage T / T^T and 1/diag(L) on `device`."""
    tr, tc, tv, dinv = ic0_factor_csr(indptr, indices, vals, n)
    t_cols, t_vals = _to_ell(tr, tc, tv, n, lane_pad)
    o = np.lexsort((tr, tc))                    # transpose: sort by column
    tt_cols, tt_vals = _to_ell(tc[o], tr[o], tv[o], n, lane_pad)
    ell = lambda c, v: ELLMatrix(
        cols=torch.as_tensor(c, device=device),
        vals=torch.as_tensor(v, dtype=dtype, device=device), n_cols=n)
    return IC0Arrays(t=ell(t_cols, t_vals), tt=ell(tt_cols, tt_vals),
                     dinv=torch.as_tensor(dinv, dtype=dtype, device=device))


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
