"""Nodal point loads, the ForceBC rows (node, dof, value), as vectors: summed
once into the full node-dof vector (the reference's VecSetValues
ADD_VALUES, triaelasticityparallelimpl1.F:976-987); every other form is that
vector indexed.  `np.add.at` adds each target's entries in input order from
0.0, so a free dof holds the same bits whichever numbering addresses it."""

from __future__ import annotations

from typing import Optional

import numpy as np

from pfemfort_tpu_torch.dofs.dofmap import DofMap


def nodal_loads(force_bc: Optional[np.ndarray], n_node: int,
                ndof: int) -> np.ndarray:
    """(n_node*ndof,) float64, loads on Dirichlet dofs kept (the full-system
    paths overwrite those rows)."""
    fvec = np.zeros(n_node * ndof, dtype=np.float64)
    if force_bc is not None and len(force_bc):
        idx = (force_bc[:, 0].astype(np.int64) * ndof
               + force_bc[:, 1].astype(np.int64))
        np.add.at(fvec, idx, force_bc[:, 2])
    return fvec


def reduced_loads(dofmap: DofMap, force_bc: Optional[np.ndarray]
                  ) -> np.ndarray:
    """(total_dof,) float64: the reduced system's equations' loads."""
    return nodal_loads(force_bc, dofmap.n_node,
                       dofmap.ndof)[dofmap.assy_for_soln]
