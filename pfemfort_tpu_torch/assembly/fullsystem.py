# Ported from pfemfort_tpu/assembly/fullsystem.py.
"""Full-size DOF system with MatZeroRows-style Dirichlet BCs.

Parity with triapoissonserialimpl3: instead of eliminating BC dofs from the
numbering, the system spans ALL node-dofs and Dirichlet rows are replaced by
identity rows with the applied value on the rhs —
`MatZeroRows(nDBC, rows, 1.0, solnTemp, rhs)`
(PFEMFort src/triapoissonserialimpl3.F:351-359, 557-558).

Like PETSc's MatZeroRows (without ZeroRowsColumns), COLUMNS are not zeroed,
so the operator is mildly nonsymmetric at BC couplings; the reference runs
CG on it anyway and converges because the BC components of the residual are
zero from the first iteration when x0 carries the BC values.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

from pfemfort_tpu_torch.sparse.dia import DIAMatrix
from pfemfort_tpu_torch.sparse.formats import ELLMatrix


def zero_dirichlet_rows(
    A: Union[DIAMatrix, ELLMatrix],
    b: torch.Tensor,
    bc_mask: torch.Tensor,     # (n,) bool, True on Dirichlet rows
    bc_values: torch.Tensor,   # (n,) applied values (0 on free rows)
):
    """Return (A', b') with BC rows replaced by identity and b'[bc]=value."""
    if isinstance(A, DIAMatrix):
        new_vals = torch.stack([
            torch.where(bc_mask, 1.0 if o == 0 else 0.0, A.vals[d])
            for d, o in enumerate(A.offsets)])
    else:
        rows = torch.arange(A.n_rows, device=A.cols.device)[:, None]
        is_diag = A.cols == rows
        new_vals = torch.where(bc_mask[:, None],
                               is_diag.to(A.vals.dtype), A.vals)
    return (dataclasses.replace(A, vals=new_vals),
            torch.where(bc_mask, bc_values, b))
