# Ported from pfemfort_tpu/parallel/halo.py.
"""Halo-exchange SpMV for row-sharded DIA matrices.

The reference's PETSc MatMult scatters ghost values between MPI neighbours
inside KSPSolve (SURVEY §2.5-2.6).  With shard-contiguous row numbering
(parallel/shard.py), a DIA matrix's off-rank reads are exactly the last /
first w rows of the ring neighbours (w = halo_width >= max |offset|), so the
exchange is two point-to-point shifts of w values, O(w) per rank instead of
an all_gather's O(N).  Requires w <= rows per rank (one-neighbour halos).

Every rank calls these functions together; the default process group is
the ring.  On a card tensor the in-shard product is kernel B1's halo entry
(`spmv_dia_halo_b1`); on a CPU tensor it is the plain form, D shifted
slices in offset order (`spmv_dia_halo`).  The JAX package's lattice
stencil form (`spmv_dia_halo_lattice`) was a TPU layout choice: it forms
the same products in the same order, so it is not carried.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from pfemfort_tpu_torch.sparse.dia import DIAMatrix, spmv_dia_halo_local
from pfemfort_tpu_torch.sparse.dia_spmv_cuda import dia_spmv_halo

Halo = Optional[torch.Tensor]


def halo_width(offsets: Tuple[int, ...], lane_pad: int = 8) -> int:
    w = max(max(offsets), -min(offsets), 0)
    return ((w + lane_pad - 1) // lane_pad) * lane_pad


def exchange_halos(x_local: torch.Tensor, w: int) -> Tuple[Halo, Halo]:
    """(left, right) halos from the ring neighbours: left = the last w rows
    of rank r-1, right = the first w rows of rank r+1, each None where there
    is no neighbour (None stands for zeros; at world size 1 nothing is
    posted, since an empty batch_isend_irecv raises)."""
    rank, size = dist.get_rank(), dist.get_world_size()
    ops, left, right = [], None, None
    if rank > 0:
        left = torch.empty(w, dtype=x_local.dtype, device=x_local.device)
        ops += [dist.P2POp(dist.irecv, left, rank - 1),
                dist.P2POp(dist.isend, x_local[:w], rank - 1)]
    if rank < size - 1:
        right = torch.empty(w, dtype=x_local.dtype, device=x_local.device)
        ops += [dist.P2POp(dist.isend, x_local[-w:], rank + 1),
                dist.P2POp(dist.irecv, right, rank + 1)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return left, right


def spmv_dia_halo(offsets: Tuple[int, ...], vals_local: torch.Tensor,
                  x_local: torch.Tensor, w: int) -> torch.Tensor:
    """y_local = (A x)_local, the plain 1-D form: the halos exchanged, then
    D shifted multiply-adds over [left | x_local | right], in offset
    order."""
    A = DIAMatrix(vals=vals_local, offsets=tuple(offsets),
                  n_rows=x_local.shape[0])
    return spmv_dia_halo_local(A, x_local, *exchange_halos(x_local, w))


def spmv_dia_halo_b1(A_local: DIAMatrix, x_local: torch.Tensor, w: int,
                     offsets: torch.Tensor) -> torch.Tensor:
    """y_local = (A x)_local through kernel B1's halo entry (a CPU tensor
    takes its plain version): the halos exchanged, then one launch that
    reads them in place.  `offsets`: A_local.offsets as an int32 tensor on
    its device, made once outside the iteration loop."""
    left, right = exchange_halos(x_local, w)
    return dia_spmv_halo(A_local, x_local, left, right, offsets)

