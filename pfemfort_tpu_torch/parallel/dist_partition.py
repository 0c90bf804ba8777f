# Ported from pfemfort_tpu/parallel/dist_partition.py (rcb_partition_device and _group_quantile).
"""Device-side (SPMD) recursive coordinate bisection: the ParMETIS analog.

The reference's distributed partitioner is ParMETIS_V3_PartMeshKway over MPI
(PFEMFort src/meshpartitionfortparmetis.cpp:393-413): each rank holds a
block of elements and the k-way partition is computed in parallel.  Here
each rank passes its own block of element centroids and gets its own part
ids back; every step is elementwise arithmetic and reductions on the
rank's device, joined across ranks by a few all_reduces:

  * per-group axis extents: a local scatter min / max, then one
    all_reduce(MIN) and one all_reduce(MAX) per level;
  * the split coordinate: an iterative histogram quantile (3 rounds of 128
    bins, 2^21 resolution), each round a local count and one
    all_reduce(SUM);
  * proportional fractions, so any n_parts splits (as
    parallel/partition.py:rcb_partition does).

The arithmetic on coordinates is the JAX package's float32, in its order,
so the part ids are the JAX package's.  Counts are integers (int64): the
JAX package counts in float32, which stops being exact above 2^24 elements;
below that both give the same counts.  Without a process group, or at
world size 1, the call is the whole computation.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pfemfort_tpu_torch.utils.device import resolve_device


def _all_reduce(t: torch.Tensor, op) -> torch.Tensor:
    """Reduce `t` over every rank in place (nothing without a group or at
    world size 1)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.all_reduce(t, op=op)
    return t


def _split_tree(n_parts: int) -> Tuple[List[Dict[int, Tuple[int, int]]],
                                       Dict[int, int]]:
    """The host-side (static) tree: per level, group -> (k_total, k_left);
    and the leaves' part counts."""
    levels = []
    sizes = {0: n_parts}
    while any(k > 1 for k in sizes.values()):
        lvl, nxt = {}, {}
        for g, k in sizes.items():
            if k <= 1:
                nxt[2 * g], nxt[2 * g + 1] = k, 0
                lvl[g] = (k, k)          # no split
                continue
            kl = k // 2
            lvl[g] = (k, kl)
            nxt[2 * g], nxt[2 * g + 1] = kl, k - kl
        levels.append(lvl)
        sizes = nxt
    return levels, sizes


def _group_quantile(x: torch.Tensor, gid: torch.Tensor, frac: torch.Tensor,
                    n_groups: int, lo: torch.Tensor, hi: torch.Tensor,
                    rounds: int = 3, bins: int = 128) -> torch.Tensor:
    """Per-group approximate `frac`-quantile of x over every rank's
    elements by iterative histogram refinement.  x (n,) float32, gid (n,)
    int64, frac/lo/hi (n_groups,) float32.  Returns (n_groups,) float32
    split values."""
    total = torch.bincount(gid, minlength=n_groups)
    _all_reduce(total, dist.ReduceOp.SUM)
    # frac * total in float32 (the JAX package's product); later targets
    # are that value less integer counts, exact in float64
    target = (frac * total.to(torch.float32)).to(torch.float64)
    for _ in range(rounds):
        width = torch.clamp(hi - lo, min=1e-30)
        # bin of each element within its group's current window; elements
        # outside the window are masked out (their rank is already folded
        # into `target` by earlier rounds)
        t = (x - lo[gid]) / width[gid]
        inside = (t >= 0.0) & (t < 1.0)
        b = torch.clamp((t * bins).to(torch.int64), 0, bins - 1)
        hist = torch.bincount((gid * bins + b)[inside],
                              minlength=n_groups * bins)
        _all_reduce(hist, dist.ReduceOp.SUM)
        cum = torch.cumsum(hist.reshape(n_groups, bins), dim=1)
        # first bin where the cumulative count reaches the target
        reached = cum.to(torch.float64) >= target[:, None]
        idx = torch.argmax(reached.to(torch.int32), dim=1)
        below = torch.where(
            idx > 0,
            torch.gather(cum, 1, torch.clamp(idx - 1, min=0)[:, None])[:, 0],
            0)
        target = target - below.to(torch.float64)
        lo2 = lo + idx.to(lo.dtype) * width / bins
        hi2 = lo2 + width / bins
        lo, hi = lo2, hi2
    return 0.5 * (lo + hi)


def rcb_partition_device(centroids_l, n_parts: int, *,
                         device="cuda") -> torch.Tensor:
    """This rank's (E_l, ndim) element centroids -> its (E_l,) int32 part
    ids, computed on `device` (a numpy array or tensor; it is taken as
    float32 on `device`).  Every rank of the default process group calls it
    together with its own block; the blocks together are the mesh."""
    device = resolve_device(device)
    c = torch.as_tensor(centroids_l, dtype=torch.float32, device=device)
    E, ndim = c.shape
    levels, sizes = _split_tree(n_parts)

    gid = torch.zeros(E, dtype=torch.int64, device=device)
    for li, lvl in enumerate(levels):
        n_groups = 1 << li
        fracs = np.ones(n_groups, dtype=np.float32)
        splitmask = np.zeros(n_groups, dtype=bool)
        for g in range(n_groups):
            k, kl = lvl.get(g, (1, 1))
            if k > 1:
                fracs[g] = kl / k
                splitmask[g] = True
        fracs_t = torch.as_tensor(fracs, device=device)
        split_t = torch.as_tensor(splitmask, device=device)

        # per-group extents per axis (an empty group keeps +inf / -inf)
        idx = gid[:, None].expand(E, ndim)
        mins = torch.full((n_groups, ndim), float("inf"),
                          dtype=torch.float32, device=device)
        maxs = torch.full((n_groups, ndim), -float("inf"),
                          dtype=torch.float32, device=device)
        mins.scatter_reduce_(0, idx, c, reduce="amin")
        maxs.scatter_reduce_(0, idx, c, reduce="amax")
        _all_reduce(mins, dist.ReduceOp.MIN)
        _all_reduce(maxs, dist.ReduceOp.MAX)
        axis = torch.argmax(maxs - mins, dim=1)               # (n_groups,)
        xsel = torch.gather(c, 1, axis[gid][:, None])[:, 0]   # (E,)
        lo = torch.gather(mins, 1, axis[:, None])[:, 0]
        hi = torch.gather(maxs, 1, axis[:, None])[:, 0] + 1e-30
        split = _group_quantile(xsel, gid, fracs_t, n_groups, lo, hi)
        right = (xsel > split[gid]) & split_t[gid]
        gid = 2 * gid + right.to(torch.int64)

    # leaf group id -> part id (host-side static map)
    leaf_to_part = np.zeros(1 << len(levels), dtype=np.int32)
    part = 0
    for g in sorted(sizes):
        if sizes[g] >= 1:
            leaf_to_part[g] = part
            part += 1
    return torch.as_tensor(leaf_to_part, device=device)[gid]
