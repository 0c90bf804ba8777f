# Ported from pfemfort_tpu/sparse/dia.py.
"""DIA (diagonal-offset) sparse format for lattice-structured FEM matrices.

After lexicographic node numbering, the reduced stiffness matrix of every
structured benchmark mesh has a SMALL fixed set of nonzero diagonals —
exactly 15 offsets for the 6-tet split 3D Poisson matrix.  SpMV then needs
no gathers at all:

    y[i] = sum_d vals[d, i] * x[i + off_d]

`spmv_dia` here is the plain PyTorch form: the CPU path, and the oracle the
hand-written CUDA kernel (sparse/dia_spmv_cuda.py) is held against.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DIAMatrix:
    """Diagonal-offset matrix: vals[d, r] = A[r, r + offsets[d]].

    `lattice`: optional node-lattice shape with prod(lattice) == n_rows.
    When set, rows are points of a row-major lattice and every offset
    decomposes into a small per-axis shift.  REQUIREMENT: entries that
    would wrap across a lattice row under flat 1-D indexing are ZERO in
    `vals` (true by construction for FEM matrices assembled on the lattice:
    no element couples non-adjacent lattice points)."""

    vals: torch.Tensor        # (D, n_rows)
    offsets: Tuple[int, ...]
    n_rows: int
    lattice: Optional[Tuple[int, ...]] = None


def decompose_offsets(offsets: Tuple[int, ...],
                      shape: Tuple[int, ...]) -> Optional[Tuple[Tuple[int, ...], ...]]:
    """Decompose flat row-major offsets into per-axis lattice shifts.

    Returns one shift tuple per offset, or None if any offset does not
    decompose into shifts of magnitude < axis_size/2 (ambiguous / not a
    lattice stencil)."""
    out = []
    for o in offsets:
        rem = int(o)
        shifts = []
        ok = True
        for L in reversed(shape):
            d = rem - round(rem / L) * L    # balanced remainder in (-L/2, L/2]
            if abs(d) * 2 >= L:
                ok = False
                break
            shifts.append(d)
            rem = (rem - d) // L
        if not ok or rem != 0:
            return None
        out.append(tuple(reversed(shifts)))
    return tuple(out)


def _spmv_dia_lattice(A: DIAMatrix, x: torch.Tensor,
                      shifts: Tuple[Tuple[int, ...], ...]) -> torch.Tensor:
    """y = A x as an N-D lattice stencil: one shifted window of a padded x
    per diagonal."""
    shape = A.lattice
    nd = len(shape)
    pads = [max((abs(s[a]) for s in shifts), default=0) for a in range(nd)]
    xp = x.new_zeros([shape[a] + 2 * pads[a] for a in range(nd)])
    xp[tuple(slice(p, p + L) for p, L in zip(pads, shape))] = x.reshape(shape)
    y = x.new_zeros(shape)
    for d, sh in enumerate(shifts):
        xs = xp[tuple(slice(pads[a] + sh[a], pads[a] + sh[a] + shape[a])
                      for a in range(nd))]
        y = y + A.vals[d].reshape(shape) * xs
    return y.reshape(-1)


def spmv_dia(A: DIAMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x as D shifted multiply-adds (no gathers), summed in offset
    order."""
    if A.lattice is not None and min(A.lattice) >= 5:
        shifts = decompose_offsets(A.offsets, A.lattice)
        if shifts is not None:
            return _spmv_dia_lattice(A, x, shifts)
    offs = A.offsets
    neg = max(0, -min(offs))
    pos = max(0, max(offs))
    n = A.n_rows
    xpad = torch.cat([x.new_zeros(neg), x, x.new_zeros(pos)])
    y = torch.zeros_like(x)
    for d, o in enumerate(offs):
        y = y + A.vals[d] * xpad[neg + o:neg + o + n]
    return y


def halo_extent(A: DIAMatrix, left: Optional[torch.Tensor],
                right: Optional[torch.Tensor]) -> int:
    """The halo width w of a (left, right) pair, None standing for zeros;
    both given halos have w values and w covers every offset."""
    given = [h for h in (left, right) if h is not None]
    reach = max(max(A.offsets, default=0), -min(A.offsets, default=0), 0)
    if not given:
        return reach
    w = given[0].shape[0]
    if any(tuple(h.shape) != (w,) for h in given) or w < reach:
        raise ValueError(f"halos of shapes {[tuple(h.shape) for h in given]}"
                         f" for offsets reaching {reach}: each must be (w,) "
                         "with w >= the largest |offset|")
    return w


def spmv_dia_halo_local(A: DIAMatrix, x_l: torch.Tensor,
                        left: Optional[torch.Tensor],
                        right: Optional[torch.Tensor]) -> torch.Tensor:
    """y = A x for a rank's block of rows: x is [left (w) | x_l | right (w)]
    (a None halo is zeros), each row summed in offset order.  The plain
    version of kernel B1's halo entry (sparse/dia_spmv_cuda.py:
    dia_spmv_halo)."""
    w = halo_extent(A, left, right)
    P = A.n_rows
    zero = x_l.new_zeros(w)
    x_ext = torch.cat([zero if left is None else left, x_l,
                       zero if right is None else right])
    y = torch.zeros_like(x_l)
    for d, o in enumerate(A.offsets):
        y = y + A.vals[d] * x_ext[w + o:w + o + P]
    return y


def dia_diagonal(A: DIAMatrix) -> torch.Tensor:
    try:
        d0 = A.offsets.index(0)
    except ValueError:
        return A.vals.new_zeros(A.n_rows)
    return A.vals[d0]
