# Ported from pfemfort_tpu/solve/amg_device.py (the routing redone for the card).
"""Device routing for the algebraic preconditioners' internals.

The SA-AMG V-cycle (solve/amg.py) and the IC(0) truncated-Neumann
application (solve/ic0.py) are built from padded-ELL blocks that stay fixed
for a solve.  Each block is laid out once, at build time, in one of three
forms:

  * 'dia':   kernel B1 (sparse/dia_spmv_cuda.py), for a square block whose
             diagonal census stays within the pattern builder's 128 offsets
             and whose diagonals read no more bytes than its ELL slots;
  * 'ell':   kernel B2 (sparse/ell_spmv_cuda.py) in the sliced layout
             (sparse/sliced.py), square or rectangular (the transfers P0
             and P0^T), sentinel column n_cols;
  * 'hybrid': a square block's dense diagonals on B1 and the rest on B2
             (sparse/hybrid.py), split at each of the JAX package's three
             (fill threshold, diagonal cap) pairs;
  * 'dense': torch.matmul, for a block of at most 24M entries (the JAX
             package's threshold) whose dense form reads no more bytes than
             its ELL slots: the deep coarse levels, which are nearly dense.

Of the eligible forms the one that reads the fewest bytes is taken (on a
tie the earlier form in the list above); an ELL block or remainder counts
the slots of its sliced layout, which is what B2 reads.  On a CPU tensor
every form takes its plain version (the kernel wrappers decide that from
the tensor's device).  The JAX package's TPU cost constants, its VMEM gate
and its slot-gather packing do not apply to the card and are not carried
over.

Reference role: PETSc PC=hypre/gamg and PC=ILU applications inside KSPSolve
(PFEMFort src/solverpetsc.F:198-209, 476).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pfemfort_tpu_torch.solve.amg import SAMGArrays, SAMGMeta
from pfemfort_tpu_torch.solve.ic0 import IC0Arrays, ic0_apply
from pfemfort_tpu_torch.sparse.dia import DIAMatrix
from pfemfort_tpu_torch.sparse.dia_spmv_cuda import dia_spmv
from pfemfort_tpu_torch.sparse.ell_spmv_cuda import ell_spmv
from pfemfort_tpu_torch.sparse.formats import ELLMatrix
from pfemfort_tpu_torch.sparse.hybrid import HybridMatrix, apply_hybrid, \
    build_hybrid_plan, hybrid_from_plan, plan_bytes
from pfemfort_tpu_torch.sparse.sliced import SlicedELL, slice_ell, \
    sliced_slots

DENSE_MAX_ENTRIES = 24_000_000
DIA_MAX_OFFSETS = 128
# (fill threshold, diagonal cap) of the hybrid splits tried per square block
# (the JAX package's amg_device.build_device_ell)
HYBRID_SPLITS = ((0.2, 48), (0.05, 160), (0.015, 384))

# Products applied per route, keyed 'dia', 'ell', 'ell_rect', 'hybrid' or
# 'dense':
# lets a caller see which form carried a preconditioner's work.
route_calls: collections.Counter = collections.Counter()


# ---------------------------------------------------------------------------
# one routed block
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeviceEll:
    """A static sparse block in the form chosen for it: exactly one of
    `ell`, `dia`, `hybrid` or `dense` is set."""
    kind: str                         # 'ell' | 'dia' | 'hybrid' | 'dense'
    n_rows: int
    n_cols: int
    ell: Optional[SlicedELL] = None
    dia: Optional[DIAMatrix] = None
    dense: Optional[torch.Tensor] = None
    hybrid: Optional[HybridMatrix] = None


def _dia_form(cols: np.ndarray, vals: np.ndarray, n: int):
    """(offsets, (D, n) values) of a square ELL block, or None when its
    slots span more than DIA_MAX_OFFSETS diagonals."""
    rows = np.broadcast_to(np.arange(n, dtype=np.int64)[:, None], cols.shape)
    valid = cols < n
    offs = cols[valid].astype(np.int64) - rows[valid]
    uniq = np.unique(offs)
    if len(uniq) > DIA_MAX_OFFSETS:
        return None
    flat = np.searchsorted(uniq, offs) * n + rows[valid]
    dvals = np.bincount(flat, weights=vals[valid], minlength=len(uniq) * n)
    return tuple(int(o) for o in uniq), dvals.reshape(len(uniq), n)


def build_device_ell(cols: np.ndarray, vals: np.ndarray, n_cols: int,
                     dtype=torch.float32, *, device) -> DeviceEll:
    """Lay out one (n, K) padded-ELL block (sentinel col >= n_cols) on
    `device` in the form that reads the fewest bytes per product."""
    cols = np.asarray(cols)
    vals = np.asarray(vals, dtype=np.float64)
    n = cols.shape[0]
    size = torch.empty((), dtype=dtype).element_size()
    cand = [(sliced_slots(cols, n_cols) * (size + 4), "ell", None)]
    if n == n_cols and n > 0:
        dia = _dia_form(cols, vals, n)
        if dia is not None:
            cand.append((len(dia[0]) * n * size, "dia", dia))
        for thr, max_d in HYBRID_SPLITS:
            plan = build_hybrid_plan(cols, n, fill_threshold=thr,
                                     max_d=max_d)
            cand.append((plan_bytes(plan, size), "hybrid", plan))
    if n * n_cols <= DENSE_MAX_ENTRIES:
        cand.append((n * n_cols * size, "dense", None))
    _, kind, dia = min(cand, key=lambda c: c[0])
    if kind == "hybrid":
        return DeviceEll(kind="hybrid", n_rows=n, n_cols=n_cols,
                         hybrid=hybrid_from_plan(dia, vals, dtype, device))
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    if kind == "dia":
        offsets, dvals = dia
        return DeviceEll(
            kind="dia", n_rows=n, n_cols=n_cols,
            dia=DIAMatrix(vals=as_t(dvals), offsets=offsets, n_rows=n))
    if kind == "dense":
        dense = np.zeros((n, n_cols), dtype=np.float64)
        ok = cols < n_cols
        rr = np.broadcast_to(np.arange(n)[:, None], cols.shape)
        np.add.at(dense, (rr[ok], cols[ok]), vals[ok])
        return DeviceEll(kind="dense", n_rows=n, n_cols=n_cols,
                         dense=as_t(dense))
    layout = slice_ell(torch.as_tensor(cols, device=device), n_cols)
    return DeviceEll(kind="ell", n_rows=n, n_cols=n_cols,
                     ell=layout.pack(as_t(vals)))


def device_ell_apply(d: DeviceEll, x: torch.Tensor) -> torch.Tensor:
    """y = B x (x of length d.n_cols; returns d.n_rows)."""
    if d.kind == "dense":
        route_calls["dense"] += 1
        return torch.matmul(d.dense, x)
    if d.kind == "dia":
        route_calls["dia"] += 1
        return dia_spmv(d.dia, x)
    if d.kind == "hybrid":
        route_calls["hybrid"] += 1
        return apply_hybrid(d.hybrid, x)
    route_calls["ell" if d.n_rows == d.n_cols else "ell_rect"] += 1
    return ell_spmv(d.ell, x)


def _host(A: ELLMatrix):
    return (A.cols.cpu().numpy(),
            A.vals.detach().cpu().to(torch.float64).numpy())


# ---------------------------------------------------------------------------
# SA-AMG hierarchy on the routed blocks
# ---------------------------------------------------------------------------

class SAMGDevice(NamedTuple):
    """Per-level routed blocks.

    Transfers are stored FACTORED: only the tentative P0 / P0^T blocks (one
    nonzero per fine row and near-nullspace mode) plus the per-level
    smoothing weight.  The smoothing factor (I - omega D^-1 A) is applied
    through the level operator:  P ec = (I - om D^-1 A)(P0 ec)  and
    P^T rf = P0^T (I - om A D^-1) rf (A symmetric)."""
    ops: Tuple[Optional[DeviceEll], ...]   # ops[0] is None when the caller
    #                                        supplies the fine operator
    p0: Tuple[DeviceEll, ...]
    p0t: Tuple[DeviceEll, ...]
    omegas: Tuple[float, ...]
    inv_diags: Tuple[torch.Tensor, ...]
    coarse_inv: torch.Tensor


def build_samg_device(arrs: SAMGArrays, sizes: Tuple[int, ...],
                      dtype=torch.float32, *, device,
                      external_fine_op: bool = False) -> SAMGDevice:
    """Route every block of a built hierarchy onto `device`.  `sizes`: rows
    per level (SAMGMeta.sizes).  `external_fine_op`: skip ops[0], the
    caller's own operator smooths the fine level."""
    def route(A: ELLMatrix) -> DeviceEll:
        return build_device_ell(*_host(A), n_cols=A.n_cols, dtype=dtype,
                                device=device)

    if tuple(A.n_rows for A in arrs.a) != tuple(sizes):
        raise ValueError(f"level sizes {sizes} do not match the hierarchy")
    ops = tuple(None if (li == 0 and external_fine_op) else route(A)
                for li, A in enumerate(arrs.a))
    as_t = lambda t: t.to(device=device, dtype=dtype)
    return SAMGDevice(ops=ops, p0=tuple(route(P) for P in arrs.p0),
                      p0t=tuple(route(P) for P in arrs.p0t),
                      omegas=tuple(arrs.omegas),
                      inv_diags=tuple(as_t(d) for d in arrs.inv_diags),
                      coarse_inv=as_t(arrs.coarse_inv))


def _vcycle_device(dev: SAMGDevice, meta: SAMGMeta, level: int,
                   r: torch.Tensor, spmv0) -> torch.Tensor:
    last = len(dev.inv_diags) - 1
    if level == last:
        return dev.coarse_inv @ r
    Dinv = dev.inv_diags[level]
    om = meta.omega_smooth
    om_p = dev.omegas[level]
    if level == 0 and spmv0 is not None:
        spmv = spmv0
    else:
        op = dev.ops[level]
        spmv = lambda x: device_ell_apply(op, x)

    e = om * Dinv * r
    for _ in range(meta.nu - 1):
        e = e + om * Dinv * (r - spmv(e))
    # factored restriction: rc = P0^T (I - om_p A D^-1) rf
    rf = r - spmv(e)
    rc = device_ell_apply(dev.p0t[level], rf - om_p * spmv(Dinv * rf))
    ec = _vcycle_device(dev, meta, level + 1, rc, None)
    # factored prolongation: e += (I - om_p D^-1 A) (P0 ec)
    pe = device_ell_apply(dev.p0[level], ec)
    e = e + pe - om_p * Dinv * spmv(pe)
    for _ in range(meta.nu):
        e = e + om * Dinv * (r - spmv(e))
    return e


def samg_device_preconditioner(dev: SAMGDevice, meta: SAMGMeta,
                               spmv0: Optional[Callable] = None
                               ) -> Callable:
    """r -> M^-1 r: one symmetric V(nu, nu) cycle with every product on the
    routed blocks.  `spmv0`: the caller's fine operator (the SAME matrix in
    the SAME row space); required when ops[0] was not built."""
    if spmv0 is None and dev.ops[0] is None:
        raise ValueError("the hierarchy was built without its fine operator: "
                         "pass spmv0")
    return lambda r: _vcycle_device(dev, meta, 0, r, spmv0)


# ---------------------------------------------------------------------------
# IC(0) on the routed blocks
# ---------------------------------------------------------------------------

class IC0Device(NamedTuple):
    """Routed T / T^T blocks + 1/diag(L)."""
    t: DeviceEll
    tt: DeviceEll
    dinv: torch.Tensor


def build_ic0_device(arrs: IC0Arrays, dtype=torch.float32,
                     *, device) -> IC0Device:
    """Route an IC0Arrays factor's triangular blocks (solve/ic0.py)."""
    route = lambda A: build_device_ell(*_host(A), n_cols=A.n_cols,
                                       dtype=dtype, device=device)
    return IC0Device(t=route(arrs.t), tt=route(arrs.tt),
                     dinv=arrs.dinv.to(device=device, dtype=dtype))


def ic0_device_preconditioner(dev: IC0Device, m: int = 4) -> Callable:
    """r -> G_m^T G_m r with the 2(m-1) T/T^T products on routed blocks
    (the same truncated-Neumann math as solve/ic0.py:ic0_preconditioner)."""
    return ic0_apply(lambda x: device_ell_apply(dev.t, x),
                     lambda x: device_ell_apply(dev.tt, x), dev.dinv, m)


# ---------------------------------------------------------------------------
# CSR permutation (solve the system in the kernel's ordered space)
# ---------------------------------------------------------------------------

def permute_csr(indptr: np.ndarray, indices: np.ndarray, vals: np.ndarray,
                order: np.ndarray):
    """A_p[i, j] = A[order[i], order[j]] with per-row column sort.

    Vectorized: gather rows via repeat/offset arithmetic, map columns
    through the inverse permutation, lexsort within rows."""
    n = len(indptr) - 1
    order = np.asarray(order, dtype=np.int64)
    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n)
    deg = np.diff(indptr)[order]
    new_indptr = np.zeros(n + 1, dtype=indptr.dtype)
    np.cumsum(deg, out=new_indptr[1:])
    nnz = int(new_indptr[-1])
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    take = (np.repeat(indptr[:-1][order], deg)
            + (np.arange(nnz, dtype=np.int64)
               - np.repeat(new_indptr[:-1], deg)))
    new_idx = inv[indices[take]]
    new_vals = vals[take]
    o = np.lexsort((new_idx, rows))
    return new_indptr, new_idx[o].astype(indices.dtype), new_vals[o]
