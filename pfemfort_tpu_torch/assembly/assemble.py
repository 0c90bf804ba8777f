# Ported from pfemfort_tpu/assembly/assemble.py (all but scatter_full).
"""Device-side assembly: one ordered segment sum per target structure.

Replaces MatSetValues/VecSetValues + MatAssemblyBegin/End
(PFEMFort src/solverpetsc.F:328-468) with sums whose index sets were
precomputed by assembly/pattern.py.

The JAX segment sums are deterministic.  `index_add_`/`scatter_add_` on a
CUDA tensor are not: they use atomics, so float sums would change order from
run to run and CG iteration counts would wander.  So every destination
array is sorted ONCE, when the plan is built (`build_assembly_plan`), and
each assembly gathers the entries into that order and reduces the sorted
segments with `torch.segment_reduce`, which has no atomics: the same
inputs give the same bits on every run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from pfemfort_tpu_torch.assembly.pattern import AssemblyPattern
from pfemfort_tpu_torch.sparse.dia import DIAMatrix
from pfemfort_tpu_torch.sparse.formats import ELLMatrix


@dataclasses.dataclass(frozen=True)
class Segments:
    """An ordered scatter: entry ids sorted by destination (stable, so each
    segment keeps entry order) and the segment boundaries.  The last
    segment collects dropped (BC) contributions and is discarded."""

    perm: torch.Tensor      # (n_entries,) int64
    offsets: torch.Tensor   # (n_segments + 1,) int64

    @classmethod
    def from_dest(cls, dest: torch.Tensor, n_segments: int) -> "Segments":
        perm = torch.sort(dest, stable=True).indices
        return cls.from_sorted(perm, dest, n_segments)

    @classmethod
    def from_sorted(cls, perm: torch.Tensor, dest: torch.Tensor,
                    n_segments: int) -> "Segments":
        counts = torch.bincount(dest, minlength=n_segments)
        offsets = torch.zeros(n_segments + 1, dtype=torch.int64,
                              device=dest.device)
        torch.cumsum(counts, 0, out=offsets[1:])
        return cls(perm=perm, offsets=offsets)

    def sum(self, values: torch.Tensor) -> torch.Tensor:
        """Per-segment sums of the flat `values`, dropped segment removed."""
        out = torch.segment_reduce(values.reshape(-1)[self.perm], "sum",
                                   offsets=self.offsets, unsafe=True)
        return out[:-1]


@dataclasses.dataclass(frozen=True)
class AssemblyPlan:
    """A pattern's index arrays on the assembly device, in the dtype torch
    indexes with, made once by `build_assembly_plan`."""

    layout: str
    n_rows: int
    mat: Segments
    rhs: Segments
    dia_offsets: Optional[Tuple[int, ...]] = None
    dia_lattice: Optional[Tuple[int, ...]] = None
    ell_cols: Optional[torch.Tensor] = None   # (n_rows, K) int32


def build_assembly_plan(pattern: AssemblyPattern, device) -> AssemblyPlan:
    """Sort every destination array of `pattern` once, on `device`."""
    device = torch.device(device)
    N = pattern.n_rows
    as_index = lambda a: torch.as_tensor(np.asarray(a), device=device).long()
    rhs = Segments.from_dest(as_index(pattern.rhs_dest), N + 1)
    if pattern.layout == "dia":
        # Destinations in the SAME (i, j, e) order as Ke: d * N + row, with
        # d the offset's index in the sorted offset table.
        D = pattern.n_offsets
        edt = as_index(pattern.elem_dof_t)                     # (ns, E)
        table = torch.tensor(pattern.dia_offsets, dtype=torch.int64,
                             device=device)
        rows, cols = edt[:, None, :], edt[None, :, :]
        d = torch.searchsorted(table, cols - rows)
        dest = torch.where((rows >= 0) & (cols >= 0), d * N + rows, D * N)
        return AssemblyPlan(
            layout="dia", n_rows=N,
            mat=Segments.from_dest(dest.reshape(-1), D * N + 1), rhs=rhs,
            dia_offsets=pattern.dia_offsets, dia_lattice=pattern.dia_lattice)
    # the pattern builder already sorted the ELL scatter (mat_perm)
    mat = Segments.from_sorted(as_index(pattern.mat_perm),
                               as_index(pattern.mat_segids),
                               pattern.mat_nsegs)
    return AssemblyPlan(
        layout="ell", n_rows=N, mat=mat, rhs=rhs,
        ell_cols=torch.as_tensor(pattern.ell_cols, dtype=torch.int32,
                                 device=device))


def assemble_dia_values(Ke: torch.Tensor, plan: AssemblyPlan) -> DIAMatrix:
    """Sum element stiffness entries (ns, ns, E) straight into (D, N)
    diagonal storage."""
    assert plan.layout == "dia"
    vals = plan.mat.sum(Ke).reshape(len(plan.dia_offsets), plan.n_rows)
    return DIAMatrix(vals=vals, offsets=plan.dia_offsets, n_rows=plan.n_rows,
                     lattice=plan.dia_lattice)


def assemble_ell_values(Ke: torch.Tensor, plan: AssemblyPlan) -> ELLMatrix:
    """General path: sorted segment sums into padded-ELL values."""
    assert plan.layout == "ell"
    vals = plan.mat.sum(Ke).reshape(plan.ell_cols.shape)
    return ELLMatrix(cols=plan.ell_cols, vals=vals, n_cols=plan.n_rows)


def assemble_matrix(Ke: torch.Tensor, plan: AssemblyPlan
                    ) -> Union[DIAMatrix, ELLMatrix]:
    """Assemble into whichever structure the pattern selected."""
    if plan.layout == "dia":
        return assemble_dia_values(Ke, plan)
    return assemble_ell_values(Ke, plan)


def assemble_rhs(Fe: torch.Tensor, plan: AssemblyPlan) -> torch.Tensor:
    """Sum element vectors (ns, E) into the reduced rhs (n_rows,)."""
    return plan.rhs.sum(Fe)


def dirichlet_rhs_correction(Ke: torch.Tensor,
                             ubc_e: torch.Tensor) -> torch.Tensor:
    """Element-level Dirichlet elimination into the RHS (element-minor).

    F_e[i,e] = - sum_j K_e[i,j,e] * ubc_e[j,e]  where ubc_e carries applied
    values on BC slots and 0 on free slots — the reference's in-assembly
    elimination (PFEMFort src/triapoissonserialimpl1.F:625-637).
    Rows that are themselves BC dofs get dropped by the rhs scatter plan.
    """
    ns = Ke.shape[1]
    return -sum(Ke[:, j, :] * ubc_e[j][None, :] for j in range(ns))
