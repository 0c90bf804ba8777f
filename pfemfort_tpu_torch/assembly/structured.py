# Ported from pfemfort_tpu/assembly/structured.py.
"""Structured slice-add assembly: scatter-free stiffness assembly for
generated box-tet and rect-tria meshes.

For the mesh the reference's generator produces (box -> 6 tets per hex,
lexicographic node numbering; genTetranovtk.cpp:203-208), every element
entry's destination is a FIXED lattice shift of the hex index: element
e = (hex, class c), its node i sits at hex_base + corner_offset(c, i), and
the (row, col) pair lands on diagonal offset(c,i,j) at a translated copy of
the hex lattice.  Assembly therefore reduces to 6*npe^2 = 96 static in-place
slice-adds of dense (nez, ney, nex) blocks into the (D, nnz, nny, nnx) DIA
value lattice.  The adds run one after another in plan order, so the sums
are deterministic, with no scatters and no atomics.  The rect_tria
lattice (2 triangles per cell) takes the same plan in 2D: 2*npe^2 adds of
(ney, nex) blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from pfemfort_tpu_torch.mesh.generate import _TET_SPLIT
from pfemfort_tpu_torch.sparse.dia import DIAMatrix, decompose_offsets


@dataclasses.dataclass(frozen=True)
class StructuredPlan:
    nex: int
    ney: int
    nez: int
    ndof: int
    offsets: Tuple[int, ...]          # DIA offsets (flat dof-id differences)
    # per entry: (class, n_row, n_col, d, rz, ry, rx, ci) where n_row/n_col
    # are flat element dof slots (i*ndof+ci, j*ndof+cj)
    entries: Tuple[Tuple[int, int, int, int, int, int, int, int], ...]
    # per (class, n_row, rz, ry, rx, ci) for the rhs
    rhs_entries: Tuple[Tuple[int, int, int, int, int, int], ...]


def _corner_bits(k: int) -> Tuple[int, int, int]:
    """pts[k] of the reference generator: (bx, by, bz) lattice bits."""
    return (k & 1, (k >> 1) & 1, (k >> 2) & 1)


# rect_tria classes (bl,br,tr)+(bl,tr,tl) as (by, bx) lattice corners:
_CLASSES_2D_TRIA = (
    ((0, 0), (0, 1), (1, 1)),
    ((0, 0), (1, 1), (1, 0)),
)


def _generic_plan(classes, dims, strides, ndof):
    """classes: per class, tuple of corner lattice coords (slowest..fastest);
    dims = (nez, ney, nex) or (ney, nex); strides = node-id stride per
    axis."""
    offsets = set()
    entries = []
    rhs_entries = []
    npe = len(classes[0])
    for c, corners in enumerate(classes):
        for i in range(npe):
            ri = corners[i]
            oi = sum(b * s for b, s in zip(ri, strides))
            for ci in range(ndof):
                rhs_entries.append((c, i * ndof + ci) + tuple(ri) + (ci,))
                for j in range(npe):
                    oj = sum(b * s for b, s in zip(corners[j], strides))
                    for cj in range(ndof):
                        o = (oj - oi) * ndof + (cj - ci)
                        offsets.add(o)
                        entries.append((c, i * ndof + ci, j * ndof + cj, o)
                                       + tuple(ri) + (ci,))
    offs = tuple(sorted(offsets))
    idx = {o: d for d, o in enumerate(offs)}
    entries = tuple(e[:3] + (idx[e[3]],) + e[4:] for e in entries)
    return offs, entries, tuple(rhs_entries)


def build_structured_plan(nex: int, ney: int, nez: int,
                          ndof: int = 1) -> StructuredPlan:
    nnx, nny = nex + 1, ney + 1
    # corners in (bz, by, bx) order, strides (sz, sy, sx)
    classes = tuple(
        tuple(_corner_bits(int(c))[::-1] for c in _TET_SPLIT[cl])
        for cl in range(6))
    offs, entries, rhs_entries = _generic_plan(
        classes, (nez, ney, nex), (nnx * nny, nnx, 1), ndof)
    return StructuredPlan(nex=nex, ney=ney, nez=nez, ndof=ndof,
                          offsets=offs, entries=entries,
                          rhs_entries=rhs_entries)


@dataclasses.dataclass(frozen=True)
class StructuredPlan2D:
    nex: int
    ney: int
    ndof: int
    offsets: Tuple[int, ...]
    entries: Tuple[tuple, ...]      # (class, nr, nc, d, ry, rx, ci)
    rhs_entries: Tuple[tuple, ...]  # (class, nr, ry, rx, ci)


def build_structured_plan_2d(nex: int, ney: int,
                             ndof: int = 1) -> StructuredPlan2D:
    """rect_tria lattice: 2 triangles per cell, node numbering x-fastest."""
    nnx = nex + 1
    offs, entries, rhs_entries = _generic_plan(
        _CLASSES_2D_TRIA, (ney, nex), (nnx, 1), ndof)
    return StructuredPlan2D(nex=nex, ney=ney, ndof=ndof, offsets=offs,
                            entries=entries, rhs_entries=rhs_entries)


def structured_plan(mesh, ndof: int):
    """(plan, matrix assembler, rhs assembler) of the structured slice-add
    assembly of a generated box_tet or rect_tria mesh's full system."""
    s = mesh.structure
    if s["kind"] == "box_tet":
        return (build_structured_plan(s["nex"], s["ney"], s["nez"],
                                      ndof=ndof),
                assemble_dia_structured, assemble_rhs_structured)
    return (build_structured_plan_2d(s["nex"], s["ney"], ndof=ndof),
            assemble_dia_structured_2d, assemble_rhs_structured_2d)


def assemble_dia_structured_2d(Ke: torch.Tensor,
                               plan: StructuredPlan2D) -> DIAMatrix:
    """Ke (ns, ns, E) with e = cell*2 + class -> DIA over the 2D lattice,
    2*ns^2 in-place slice-adds."""
    nex, ney, ndof = plan.nex, plan.ney, plan.ndof
    nnx, nny = nex + 1, ney + 1
    ns = 3 * ndof
    D = len(plan.offsets)
    vals = Ke.new_zeros((D, nny, nnx, ndof))
    Kc = Ke.reshape(ns, ns, ney, nex, 2)   # cell = (iy, ix)
    for (c, nr, nc, d, ry, rx, ci) in plan.entries:
        vals[d, ry:ry + ney, rx:rx + nex, ci] += Kc[nr, nc, :, :, c]
    lattice = (nny, nnx) if ndof == 1 else None
    return DIAMatrix(vals=vals.reshape(D, -1), offsets=plan.offsets,
                     n_rows=nnx * nny * ndof, lattice=lattice)


def assemble_rhs_structured_2d(Fe: torch.Tensor,
                               plan: StructuredPlan2D) -> torch.Tensor:
    """Fe (ns, E) -> full nodal-dof rhs (n,), 2*ns slice-adds."""
    nex, ney, ndof = plan.nex, plan.ney, plan.ndof
    ns = 3 * ndof
    rhs = Fe.new_zeros((ney + 1, nex + 1, ndof))
    Fc = Fe.reshape(ns, ney, nex, 2)
    for (c, nr, ry, rx, ci) in plan.rhs_entries:
        rhs[ry:ry + ney, rx:rx + nex, ci] += Fc[nr, :, :, c]
    return rhs.reshape(-1)


def _vals_shape(plan: StructuredPlan):
    return (len(plan.offsets), plan.nez + 1, plan.ney + 1, plan.nex + 1,
            plan.ndof)


def _add_matrix_blocks(vals, Ke, plan: StructuredPlan, z0: int, cnz: int):
    """Slice-add the Ke blocks of the hex z-layers [z0, z0 + cnz) into the
    lattice accumulator vals (D, nnz, nny, nnx, ndof), in place."""
    nex, ney, ns = plan.nex, plan.ney, 4 * plan.ndof
    Kc = Ke.reshape(ns, ns, cnz, ney, nex, 6)  # hex = (iz, iy, ix)
    for (c, nr, nc, d, rz, ry, rx, ci) in plan.entries:
        vals[d, rz + z0:rz + z0 + cnz, ry:ry + ney, rx:rx + nex, ci] += \
            Kc[nr, nc, :, :, :, c]


def _add_rhs_blocks(rhs, Fe, plan: StructuredPlan, z0: int, cnz: int):
    """Slice-add the Fe blocks of the hex z-layers [z0, z0 + cnz) into the
    lattice accumulator rhs (nnz, nny, nnx, ndof), in place."""
    nex, ney, ns = plan.nex, plan.ney, 4 * plan.ndof
    Fc = Fe.reshape(ns, cnz, ney, nex, 6)
    for (c, nr, rz, ry, rx, ci) in plan.rhs_entries:
        rhs[rz + z0:rz + z0 + cnz, ry:ry + ney, rx:rx + nex, ci] += \
            Fc[nr, :, :, :, c]


def _lattice_dia(vals: torch.Tensor, plan: StructuredPlan) -> DIAMatrix:
    D = len(plan.offsets)
    n = vals[0].numel()
    lattice = ((plan.nez + 1, plan.ney + 1, plan.nex + 1)
               if plan.ndof == 1 else None)
    return DIAMatrix(vals=vals.reshape(D, n), offsets=plan.offsets, n_rows=n,
                     lattice=lattice)


def assemble_dia_structured(Ke: torch.Tensor,
                            plan: StructuredPlan) -> DIAMatrix:
    """Ke (ns, ns, E) with e = hex*6 + class -> DIA over the node lattice.

    6*ns^2 static slice-adds; zero scatters.  Entry (class, n_row, n_col)
    lands on diagonal d at the translated hex block for component ci.
    """
    vals = Ke.new_zeros(_vals_shape(plan))
    _add_matrix_blocks(vals, Ke, plan, 0, plan.nez)
    return _lattice_dia(vals, plan)


def assemble_rhs_structured(Fe: torch.Tensor,
                            plan: StructuredPlan) -> torch.Tensor:
    """Fe (ns, E) -> full nodal-dof rhs (n,), 6*ns static slice-adds."""
    rhs = Fe.new_zeros(_vals_shape(plan)[1:])
    _add_rhs_blocks(rhs, Fe, plan, 0, plan.nez)
    return rhs.reshape(-1)


# Above this many elements the one-shot Ke + geometry temporaries are
# assembled in z-slab chunks.  The threshold was sized for a 16 GB TPU v5e
# (21 GB needed at 48M elements); on the 80 GB card it is not binding.
CHUNK_ABOVE_ELEMS = 12_000_000
CHUNK_ELEMS = 6_000_000


def chunk_count(nez: int, n_elem: int) -> int:
    """z-slab chunks for `assemble_structured_chunked`: 1 up to
    CHUNK_ABOVE_ELEMS elements, else the least divisor of nez that keeps a
    chunk under CHUNK_ELEMS elements."""
    if n_elem <= CHUNK_ABOVE_ELEMS:
        return 1
    want = -(-n_elem // CHUNK_ELEMS)
    return next((c for c in range(want, nez + 1) if nez % c == 0), 1)


def assemble_structured_chunked(element_fn: Callable, coords_em: torch.Tensor,
                                plan: StructuredPlan, n_chunks: int):
    """Memory-bounded structured assembly: elements are processed in z-slab
    chunks (matrix and rhs together), so only E/n_chunks elements' Ke and
    geometry temporaries are live at once while the (D, lattice)
    accumulator stays put.  Each chunk is a contiguous element range (the
    hex index is z-major in the generator).

    Requires nez % n_chunks == 0.
    """
    if plan.nez % n_chunks != 0:
        raise ValueError(f"nez={plan.nez} is not a multiple of "
                         f"n_chunks={n_chunks}")
    cnz = plan.nez // n_chunks
    epc = cnz * plan.ney * plan.nex * 6          # elements per chunk
    vals = coords_em.new_zeros(_vals_shape(plan))
    rhs = coords_em.new_zeros(_vals_shape(plan)[1:])
    for k in range(n_chunks):
        Ke, Fe = element_fn(coords_em[:, :, k * epc:(k + 1) * epc])
        _add_matrix_blocks(vals, Ke, plan, k * cnz, cnz)
        _add_rhs_blocks(rhs, Fe, plan, k * cnz, cnz)
    return _lattice_dia(vals, plan), rhs.reshape(-1)


def _padded(arr: torch.Tensor, pads) -> torch.Tensor:
    """Zero-pad (False for bool) every axis of arr by pads[a] on both
    sides."""
    out = arr.new_zeros([s + 2 * p for s, p in zip(arr.shape, pads)])
    out[tuple(slice(p, p + s) for p, s in zip(pads, arr.shape))] = arr
    return out


def reduce_structured_system(A_full: DIAMatrix, b_full: torch.Tensor,
                             free_box, full_shape,
                             bc_values: torch.Tensor):
    """FULL lattice system -> REDUCED (BC-eliminated) lattice system by pure
    slicing — no scatters.

    When the free nodes form a contiguous sub-box of the generator lattice
    (dofs/dofmap.py:reduced_box), the reduced DIA values are a SLICE of the
    full DIA lattice, and the Dirichlet rhs correction b -= A[:, bc] u_bc is
    D shifted multiplies of a masked u_bc (the reference's reduced
    numbering: triapoissonserialimpl1.F:320-394).

    Args:
      A_full: structured full-node-system DIA (lattice-shaped values).
      b_full: (n_full,) source-term rhs of the full system.
      free_box: ((z0, nz'), (y0, ny'), (x0, nx')) start and size of the free
        sub-box per axis.
      full_shape: (nnz, nny, nnx) full node lattice.
      bc_values: (n_full,) applied Dirichlet values (0 on free nodes).
    Returns (A_red: DIAMatrix with lattice=(nz', ny', nx'), b_red).
    """
    shifts = decompose_offsets(A_full.offsets, full_shape)
    if shifts is None:
        raise ValueError("full offsets must decompose on the lattice")
    nd = len(full_shape)
    starts = [b[0] for b in free_box]
    red_shape = tuple(b[1] for b in free_box)
    red_strides = [1] * nd
    for a in range(nd - 2, -1, -1):
        red_strides[a] = red_strides[a + 1] * red_shape[a + 1]
    n_red = int(np.prod(red_shape))

    vals_lat = A_full.vals.reshape((len(A_full.offsets),) + tuple(full_shape))
    bc_lat = bc_values.reshape(full_shape).to(b_full.dtype)
    b_lat = b_full.reshape(full_shape)

    # pad shifted reads so boxes touching a lattice edge stay in bounds
    pads = [max((abs(int(s[a])) for s in shifts), default=0)
            for a in range(nd)]
    box = tuple(slice(starts[a], starts[a] + red_shape[a]) for a in range(nd))

    def shifted_box(arrp, shift):
        return arrp[tuple(slice(starts[a] + pads[a] + int(shift[a]),
                                starts[a] + pads[a] + int(shift[a])
                                + red_shape[a]) for a in range(nd))]

    free_mask = torch.zeros(full_shape, dtype=torch.bool,
                            device=b_full.device)
    free_mask[box] = True
    free_mask_p = _padded(free_mask, pads)
    bc_lat_p = _padded(bc_lat, pads)

    red_offsets = []
    red_vals = []
    b_red = b_lat[box]
    for d, sh in enumerate(shifts):
        o_red = sum(int(sh[a]) * red_strides[a] for a in range(nd))
        v_free = vals_lat[d][box]                   # (red_shape): rows free
        # column node r + shift: free -> matrix entry; BC -> rhs correction
        col_free = shifted_box(free_mask_p, sh)     # does the col stay in box?
        col_bc = shifted_box(bc_lat_p, sh)          # applied value at col
        red_offsets.append(int(o_red))
        red_vals.append(torch.where(col_free, v_free, 0.0).reshape(-1))
        b_red = b_red - v_free * torch.where(col_free, 0.0, col_bc)

    order = np.argsort(red_offsets)
    A_red = DIAMatrix(
        vals=torch.stack([red_vals[i] for i in order]),
        offsets=tuple(int(red_offsets[i]) for i in order),
        n_rows=n_red,
        lattice=red_shape)
    return A_red, b_red.reshape(-1)
