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
from pfemfort_tpu_torch.sparse.dia import DIAMatrix
from pfemfort_tpu_torch.sparse.formats import ELLMatrix


def dia_from_numpy(vals: np.ndarray, offsets: Sequence[int], n_rows: int,
                   lattice: Optional[Sequence[int]], device="cpu",
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
                   device="cpu", dtype: Optional[torch.dtype] = None
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
