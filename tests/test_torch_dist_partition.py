"""Port parity: parallel/dist_partition.py:rcb_partition_device.

In this process (no process group, so one block is the whole
computation): the part ids equal the JAX package's rcb_partition_device
element for element on tests/test_dist_partition.py's point sets (20,000
points in a 1x2x8 box at k = 2, 4, 7, 8; the element centroids of an
8x8x32 box_tet mesh at k = 8; 16,384 points in the unit cube at k = 8), and
the JAX test's balance and geometric bars hold.  On 2, 4 and 8 gloo ranks
(this file run as a script under torchrun, one launch per world size; the
ranks never import JAX), each rank passes its own contiguous block of the
points, and the concatenation of the ranks' part ids equals the
single-process result.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from pfemfort_tpu_torch.mesh import generate
from pfemfort_tpu_torch.parallel import multihost
from pfemfort_tpu_torch.parallel.dist_partition import rcb_partition_device

WORLDS = (2, 4, 8)
KS = (2, 4, 7, 8)


def _cases():
    """name -> (points (n, 3) float64, n_parts)."""
    pts = np.random.default_rng(0).uniform(size=(20000, 3)) \
        * np.array([1.0, 2.0, 8.0])
    out = {f"uniform k={k}": (pts, k) for k in KS}
    mesh, _ = generate.box_tet(0, 1, 8, 0, 1, 8, 0, 4, 32)
    out["box 8x8x32"] = (mesh.elem_centroids(), 8)
    out["cube 16384"] = (np.random.default_rng(1).uniform(size=(16384, 3)),
                         8)
    return out


def _block(n, rank, size):
    return slice(rank * n // size, (rank + 1) * n // size)


def _ranks(outdir):
    import torch.distributed as dist

    assert "jax" not in sys.modules
    rank, size = dist.get_rank(), dist.get_world_size()
    out = {}
    for i, (pts, k) in enumerate(_cases().values()):
        out[f"part{i}"] = rcb_partition_device(
            pts[_block(len(pts), rank, size)], k, device="cpu").numpy()
    np.savez(Path(outdir) / f"rank{rank}.npz", **out)
    assert "jax" not in sys.modules


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = {}
    for size in WORLDS:
        d = tmp_path_factory.mktemp(f"world{size}")
        rc = multihost.torchrun_ranks([__file__, str(d)], size, timeout=300)
        assert rc == 0
        out[size] = [dict(np.load(d / f"rank{r}.npz"))
                     for r in range(size)]
    return out


NAMES = tuple(_cases())


@pytest.fixture(scope="module")
def single():
    return {name: rcb_partition_device(pts, k, device="cpu").numpy()
            for name, (pts, k) in _cases().items()}


@pytest.mark.parametrize("name", NAMES)
def test_part_ids_equal_jax(single, name):
    import jax
    import jax.numpy as jnp
    from pfemfort_tpu.parallel.dist_partition import \
        rcb_partition_device as j_rcb

    pts, k = _cases()[name]
    ref = np.asarray(jax.jit(j_rcb, static_argnums=1)(jnp.asarray(pts), k))
    part = single[name]
    assert part.dtype == np.int32
    np.testing.assert_array_equal(part, ref)
    counts = np.bincount(part, minlength=k)
    assert counts.min() > 0
    assert counts.max() <= 1.05 * len(pts) / k + 64


def test_box_parts_are_compact_blocks(single):
    """The JAX test's geometric bar: every part's extent product is under
    0.35 of the box's volume (slabs/blocks, no interleaving)."""
    cent, k = _cases()["box 8x8x32"]
    part = single["box 8x8x32"]
    for p in range(k):
        sel = cent[part == p]
        ext = sel.max(axis=0) - sel.min(axis=0)
        assert np.prod(ext + 1e-9) < 0.35 * 4.0


@pytest.mark.parametrize("size", WORLDS)
def test_rank_blocks_concatenate_to_the_single_process_ids(ranks, single,
                                                           size):
    for i, name in enumerate(NAMES):
        got = np.concatenate([r[f"part{i}"] for r in ranks[size]])
        np.testing.assert_array_equal(got, single[name], err_msg=name)


def test_cuda_default_raises_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        rcb_partition_device(np.zeros((4, 3)), 2)


if __name__ == "__main__":      # one rank, as the `ranks` fixture starts it
    multihost.initialize(device="cpu")
    try:
        _ranks(sys.argv[1])
    finally:
        multihost.shutdown()
