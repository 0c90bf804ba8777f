"""Carry state from the JAX package into the port as plain numpy arrays.

Neither side imports the other: a caller that holds both (the parity tests)
converts a JAX object to numpy arrays and builds the port's object from
them here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from pfemfort_tpu_torch.mesh.core import Mesh
from pfemfort_tpu_torch.sparse.dia import DIAMatrix


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


def mesh_from_numpy(etype: str, coords: np.ndarray, conn: np.ndarray,
                    structure: Optional[dict] = None) -> Mesh:
    """The port's Mesh from the fields of a JAX Mesh (host arrays)."""
    return Mesh(etype, np.array(coords, dtype=np.float64),
                np.array(conn, dtype=np.int32),
                structure=None if structure is None else dict(structure))
