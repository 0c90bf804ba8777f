"""Port parity: per-rank DIA assembly (parallel/dist_assembly.py through
drivers/sharded.py:assemble_implicit_sharded).

Each world size (2, 4, 8 gloo ranks) is launched once (this file run as a
script under torchrun; the rank processes never import JAX) and assembles, on every rank, its own
rows of a Poisson box and of a 3D elasticity box with a point load; the JAX
package's shard_map assembly of the same systems runs in this process.
float64: each rank's (D, P) values and (P,) rhs within 1e-12 of JAX's
block, and a second assembly on the rank equal bit for bit.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pfemfort_tpu_torch.drivers.sharded import assemble_implicit_sharded
from pfemfort_tpu_torch.elements.elasticity import dmat_3d, \
    elasticity_stiffness
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
from pfemfort_tpu_torch.mesh import generate
from pfemfort_tpu_torch.parallel import multihost
from pfemfort_tpu_torch.parallel.dist_assembly import build_dist_setup

WORLDS = (2, 4, 8)
E, NU = 240.565, 0.3


def _cases(size, gen=generate):
    """name -> (mesh, ndof, dbc, fbc, element_fn builder)."""
    mesh, dbc = gen.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4 * size)
    el, _ = gen.box_tet(0, 1, 3, 0, 1, 3, 0, 1, 4 * size)
    base = np.nonzero(np.isclose(el.coords[:, 2], 0))[0]
    el_dbc = np.array([[n, d, 0.0] for n in base for d in (0, 1, 2)])
    tip = int(np.argmax(el.coords[:, 2]))
    fbc = np.array([[tip, 0, 1.0], [tip, 2, -0.5]])
    return {"poisson": (mesh, 1, dbc, None, "poisson"),
            "elasticity": (el, 3, el_dbc, fbc, "elasticity")}


def _element_fn(kind, pkg):
    if kind == "poisson":
        return lambda c: pkg.poisson(c, "tetra4", source=-6.0)
    D = pkg.dmat_3d(E, NU)
    return lambda c: pkg.elasticity(c, "tetra4", D)


class _Torch:
    poisson = staticmethod(poisson_element_matrices)
    elasticity = staticmethod(elasticity_stiffness)
    dmat_3d = staticmethod(dmat_3d)


def _ranks(outdir):
    import torch.distributed as dist

    assert "jax" not in sys.modules
    rank, size = dist.get_rank(), dist.get_world_size()
    out = {}
    for name, (mesh, ndof, dbc, fbc, kind) in _cases(size).items():
        setup = build_dist_setup(mesh, ndof, dbc, size, rank)
        fn = _element_fn(kind, _Torch)
        runs = [assemble_implicit_sharded(setup, fn, torch.float64, "cpu",
                                          fbc) for _ in range(2)]
        (v1, b1), (v2, b2) = runs
        out[f"{name}_vals"], out[f"{name}_b"] = v1.numpy(), b1.numpy()
        out[f"{name}_repeat"] = torch.equal(v1, v2) and torch.equal(b1, b2)
    np.savez(Path(outdir) / f"rank{rank}.npz", **out)
    assert "jax" not in sys.modules


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = {}
    for size in WORLDS:
        d = tmp_path_factory.mktemp(f"world{size}")
        rc = multihost.torchrun_ranks([__file__, str(d)], size,
                                         timeout=300)
        assert rc == 0
        out[size] = [dict(np.load(d / f"rank{r}.npz"))
                     for r in range(size)]
    return out


@pytest.mark.parametrize("name", ["poisson", "elasticity"])
@pytest.mark.parametrize("size", WORLDS)
def test_per_rank_assembly_matches_jax(ranks, size, name):
    import jax
    import jax.numpy as jnp
    from pfemfort_tpu.drivers.sharded import \
        assemble_implicit_sharded as j_assemble
    from pfemfort_tpu.elements import elasticity as jel
    from pfemfort_tpu.elements import poisson as jpo
    from pfemfort_tpu.mesh import generate as jgen
    from pfemfort_tpu.parallel.dist_assembly import \
        build_dist_setup as j_setup

    class _Jax:
        poisson = staticmethod(jpo.poisson_element_matrices)
        elasticity = staticmethod(jel.elasticity_stiffness)
        dmat_3d = staticmethod(jel.dmat_3d)

    mesh, ndof, dbc, fbc, kind = _cases(size, jgen)[name]
    setup = j_setup(mesh, ndof, dbc, size)
    dm = jax.sharding.Mesh(np.array(jax.devices()[:size]), ("shard",))
    vals, b = j_assemble(setup, _element_fn(kind, _Jax), dm, jnp.float64,
                         fbc)
    vals, b = np.asarray(vals), np.asarray(b)
    P = setup.rows_per_shard
    assert np.abs(vals).max() > 0 and np.abs(b).max() > 0
    for r, res in enumerate(ranks[size]):
        sl = slice(r * P, (r + 1) * P)
        np.testing.assert_allclose(res[f"{name}_vals"], vals[:, sl], rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(res[f"{name}_b"], b[sl], rtol=0,
                                   atol=1e-12)
        assert res[f"{name}_repeat"]


if __name__ == "__main__":      # one rank, as the `ranks` fixture starts it
    multihost.initialize(device="cpu")
    try:
        _ranks(sys.argv[1])
    finally:
        multihost.shutdown()
