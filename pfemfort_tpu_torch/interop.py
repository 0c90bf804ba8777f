"""Carry state from the JAX package into the port as plain numpy arrays.

Neither side imports the other: a caller that holds both (the parity tests)
converts a JAX object to numpy arrays and builds the port's object from
them here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from pfemfort_tpu_torch.assembly.pattern import AssemblyPattern
from pfemfort_tpu_torch.mesh.core import Mesh
from pfemfort_tpu_torch.solve.amg import SAMGArrays, SAMGMeta
from pfemfort_tpu_torch.solve.ic0 import IC0Arrays
from pfemfort_tpu_torch.solve.multigrid import GMGArrays, GMGMeta
from pfemfort_tpu_torch.sparse.dia import DIAMatrix
from pfemfort_tpu_torch.sparse.formats import ELLMatrix


def dia_from_numpy(vals: np.ndarray, offsets: Sequence[int], n_rows: int,
                   lattice: Optional[Sequence[int]], *, device,
                   dtype: Optional[torch.dtype] = None) -> DIAMatrix:
    """The port's DIAMatrix from the fields of a JAX DIAMatrix (vals as a
    (D, n_rows) numpy array).  dtype None means torch.get_default_dtype()."""
    vals = np.asarray(vals)
    offsets = tuple(int(o) for o in offsets)
    if vals.shape != (len(offsets), int(n_rows)):
        raise ValueError(f"vals shape {vals.shape} does not match "
                         f"{len(offsets)} offsets x {n_rows} rows")
    return DIAMatrix(
        vals=torch.tensor(vals, dtype=dtype or torch.get_default_dtype(),
                          device=device),
        offsets=offsets,
        n_rows=int(n_rows),
        lattice=None if lattice is None else tuple(int(a) for a in lattice))


def ell_from_numpy(cols: np.ndarray, vals: np.ndarray, n_cols: int,
                   *, device, dtype: Optional[torch.dtype] = None
                   ) -> ELLMatrix:
    """The port's ELLMatrix from the fields of a JAX ELLMatrix ((N, K)
    numpy cols and vals).  dtype None means torch.get_default_dtype()."""
    cols, vals = np.asarray(cols), np.asarray(vals)
    if cols.ndim != 2 or vals.shape != cols.shape:
        raise ValueError(f"cols {cols.shape} and vals {vals.shape} must be "
                         "one (N, K) shape")
    if cols.size and (cols.min() < 0 or cols.max() >= 2**31):
        raise ValueError("ELL columns must lie in [0, 2**31)")
    return ELLMatrix(
        cols=torch.tensor(cols, dtype=torch.int32, device=device),
        vals=torch.tensor(vals, dtype=dtype or torch.get_default_dtype(),
                          device=device),
        n_cols=int(n_cols))


def pattern_from_numpy(**fields) -> AssemblyPattern:
    """The port's AssemblyPattern from the fields of a JAX pattern (numpy
    arrays, tuples and ints, e.g. `dataclasses.asdict(jax_pattern)`)."""
    out = {}
    for name, v in fields.items():
        if name in ("dia_offsets", "dia_lattice") and v is not None:
            v = tuple(int(a) for a in v)
        elif hasattr(v, "__array__"):
            v = np.asarray(v)
        out[name] = v
    return AssemblyPattern(**out)


def mesh_from_numpy(etype: str, coords: np.ndarray, conn: np.ndarray,
                    structure: Optional[dict] = None) -> Mesh:
    """The port's Mesh from the fields of a JAX Mesh (host arrays)."""
    return Mesh(etype, np.array(coords, dtype=np.float64),
                np.array(conn, dtype=np.int32),
                structure=None if structure is None else dict(structure))


def _tensor(a, device, dtype):
    return torch.tensor(np.asarray(a), dtype=dtype or torch.get_default_dtype(),
                        device=device)


def samg_from_numpy(arrays, meta, *, device,
                    dtype: Optional[torch.dtype] = None):
    """(SAMGArrays, SAMGMeta) of the port from a JAX SA-AMG hierarchy:
    `arrays` with the fields of pfemfort_tpu.solve.amg.SAMGArrays (the
    a/p/pt/p0/p0t cols and vals per level, omegas, inv_diags, coarse_inv;
    numpy or anything np.asarray takes) and `meta` with sizes, nu and
    omega_smooth."""
    def ells(cols, vals, n_cols):
        return tuple(ell_from_numpy(c, v, nc, device=device, dtype=dtype)
                     for c, v, nc in zip(cols, vals, n_cols))

    sizes = tuple(int(s) for s in meta.sizes)
    a = ells(arrays.a_cols, arrays.a_vals, sizes)
    out = SAMGArrays(
        a=a,
        p=ells(arrays.p_cols, arrays.p_vals, sizes[1:]),
        pt=ells(arrays.pt_cols, arrays.pt_vals, sizes[:-1]),
        p0=ells(arrays.p0_cols, arrays.p0_vals, sizes[1:]),
        p0t=ells(arrays.p0t_cols, arrays.p0t_vals, sizes[:-1]),
        omegas=tuple(float(o) for o in arrays.omegas),
        inv_diags=tuple(_tensor(d, device, dtype) for d in arrays.inv_diags),
        coarse_inv=_tensor(arrays.coarse_inv, device, dtype))
    return out, SAMGMeta(sizes=sizes, nu=int(meta.nu),
                         omega_smooth=float(meta.omega_smooth))


def gmg_from_numpy(arrays, meta, *, device,
                   dtype: Optional[torch.dtype] = None):
    """(GMGArrays, GMGMeta) of the port from a JAX geometric-multigrid
    hierarchy: `arrays` with the fields of
    pfemfort_tpu.solve.multigrid.GMGArrays (mats as DIA matrices with vals,
    offsets, n_rows and lattice; inv_diags, masks, coarse_inv) and `meta`
    with shapes, ndof, nu, omega and coarse_cheby."""
    mats = tuple(dia_from_numpy(A.vals, A.offsets, A.n_rows, A.lattice,
                                device=device, dtype=dtype)
                 for A in arrays.mats)
    out = GMGArrays(
        mats=mats,
        inv_diags=tuple(_tensor(d, device, dtype) for d in arrays.inv_diags),
        masks=tuple(_tensor(m, device, dtype) for m in arrays.masks),
        coarse_inv=_tensor(arrays.coarse_inv, device, dtype))
    cheby = None if meta.coarse_cheby is None else (
        float(meta.coarse_cheby[0]), float(meta.coarse_cheby[1]),
        int(meta.coarse_cheby[2]))
    return out, GMGMeta(
        shapes=tuple(tuple(int(a) for a in s) for s in meta.shapes),
        ndof=int(meta.ndof), nu=int(meta.nu), omega=float(meta.omega),
        coarse_cheby=cheby)


def ic0_from_numpy(arrays, *, device,
                   dtype: Optional[torch.dtype] = None) -> IC0Arrays:
    """The port's IC0Arrays from a JAX IC(0) factor: `arrays` with the
    fields of pfemfort_tpu.solve.ic0.IC0Arrays (t_cols, t_vals, tt_cols,
    tt_vals, dinv); the sentinel column is n = len(dinv)."""
    n = int(np.asarray(arrays.dinv).shape[0])
    return IC0Arrays(
        t=ell_from_numpy(arrays.t_cols, arrays.t_vals, n, device=device,
                         dtype=dtype),
        tt=ell_from_numpy(arrays.tt_cols, arrays.tt_vals, n, device=device,
                          dtype=dtype),
        dinv=_tensor(arrays.dinv, device, dtype))


def _samg_meta(meta) -> SAMGMeta:
    return SAMGMeta(sizes=tuple(int(s) for s in meta.sizes), nu=int(meta.nu),
                    omega_smooth=float(meta.omega_smooth))


def dist_samg_from_numpy(p0_cols_s, p0_vals_s, om0, tail, metas, rank: int,
                         *, device, dtype: Optional[torch.dtype] = None):
    """Rank `rank`'s share of a JAX distributed SA-AMG hierarchy
    (pfemfort_tpu.solve.amg.DistSAMG and its (meta, tail_meta)) as the
    port's solve/amg.py:DistSAMG: `p0_cols_s`/`p0_vals_s` the (S, P, K0)
    tentative-prolongator row blocks, `om0` the level-0 weight, `tail` with
    the fields of a JAX SAMGArrays (levels 1+), `metas` the two metas with
    sizes, nu and omega_smooth."""
    from pfemfort_tpu_torch.solve.amg import dist_samg_from_blocks

    meta, tail_meta = (_samg_meta(m) for m in metas)
    tail_arrs, _ = samg_from_numpy(tail, tail_meta, device="cpu",
                                   dtype=dtype)
    return dist_samg_from_blocks(
        np.asarray(p0_cols_s)[rank], np.asarray(p0_vals_s)[rank], float(om0),
        tail_arrs, (meta, tail_meta),
        dtype=dtype or torch.get_default_dtype(), device=device)


def dist_mg_setup_from_numpy(setup, rank: int, *, device,
                             dtype: Optional[torch.dtype] = None):
    """Rank `rank`'s parallel/dist_mg.py:DistMGSetup from a JAX DistMGSetup
    (`setup` with its fields: the stacked per-shard coords_s/validz_s, the
    padded bc_mask_pad/bc_vals_pad, the plan's nex/ney/nez and the coarse
    (GMGArrays, GMGMeta)), the coarse hierarchy staged on `device`."""
    from pfemfort_tpu_torch.assembly.structured import build_structured_plan
    from pfemfort_tpu_torch.parallel.dist_mg import DistMGSetup

    plan = build_structured_plan(int(setup.plan.nex), int(setup.plan.ney),
                                 int(setup.plan.nez), ndof=int(setup.ndof))
    if tuple(plan.offsets) != tuple(int(o) for o in setup.offsets):
        raise ValueError("the setup's offsets are not its plan's")
    P = int(setup.planes_per_shard) * int(setup.nny) * int(setup.nnx) \
        * int(setup.ndof)
    rows = slice(rank * P, (rank + 1) * P)
    return DistMGSetup(
        n_shards=int(setup.n_shards), rank=rank, ndof=int(setup.ndof),
        nnx=int(setup.nnx), nny=int(setup.nny),
        nnz_true=int(setup.nnz_true),
        planes_per_shard=int(setup.planes_per_shard), offsets=plan.offsets,
        w=int(setup.w), plan=plan,
        coords=np.asarray(setup.coords_s, dtype=np.float64)[rank],
        validz=np.asarray(setup.validz_s, dtype=np.float64)[rank],
        bc_mask=np.asarray(setup.bc_mask_pad, dtype=bool)[rows],
        bc_vals=np.asarray(setup.bc_vals_pad, dtype=np.float64)[rows],
        coarse=gmg_from_numpy(*setup.coarse, device=device, dtype=dtype),
        nu=int(setup.nu), omega=float(setup.omega))
