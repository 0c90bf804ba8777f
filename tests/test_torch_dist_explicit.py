"""Port parity: dynamics/sharded.py:explicit_dynamics_sharded on 2 and 4
gloo ranks.

Each world size is launched once (this file run as a script under
torchrun; the ranks never import JAX) and runs the JAX package's
tests/test_sharded_explicit.py cases: the 2D tria strip (rect_tria 4x12 on
[0,1]x[0,4], clamped at y=0, a body-force pulse, probes 10/11) at 2 and 4
ranks and the 3D tet column (box_tet 3x3x9, clamped at z=0, a constant body
force) at 4 ranks.  Against the JAX package's explicit_dynamics_sharded in
this process (shard_map on virtual CPU devices), float64, at the JAX
test's tolerances: disp, velo, acce and the probe history.  In float32,
every rank runs each case twice: the two runs give the same bits, and
every rank returns the same whole result.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pfemfort_tpu_torch.dynamics.sharded import build_sharded_explicit, \
    explicit_dynamics_sharded
from pfemfort_tpu_torch.mesh import generate
from pfemfort_tpu_torch.parallel import multihost

WORLDS = (2, 4)
FIELDS = ("disp", "velo", "acce", "probe_history")


def _cases(gen=generate):
    """name -> (mesh, dbc, (E, nu, dens, dt, nsteps), probes, 3D?)."""
    strip = gen.rect_tria(0, 1, 4, 0, 4, 12)
    left = np.nonzero(np.isclose(strip.coords[:, 1], 0))[0]
    column, _ = gen.box_tet(0, 1, 3, 0, 1, 3, 0, 3, 9)
    base = np.nonzero(np.isclose(column.coords[:, 2], 0))[0]
    return {
        "2d": (strip, np.array([[n, d, 0.0] for n in left for d in (0, 1)]),
               (200.0, 0.3, 10.0, 1e-4, 40), (10, 11)),
        "3d": (column,
               np.array([[n, d, 0.0] for n in base for d in (0, 1, 2)]),
               (200.0, 0.3, 10.0, 5e-5, 25), ()),
    }


def _names(size):
    return ("2d", "3d") if size == 4 else ("2d",)


def _pulse(t):
    return torch.stack([torch.where(t <= 0.1, 1.0, 0.0).to(t.dtype),
                        torch.zeros((), dtype=t.dtype, device=t.device)])


def _constant(t):
    return torch.tensor([1.0, 0.0, 0.0], dtype=t.dtype, device=t.device)


def _ranks(outdir):
    import torch.distributed as dist

    assert "jax" not in sys.modules
    rank, size = dist.get_rank(), dist.get_world_size()
    out = {}
    for name in _names(size):
        mesh, dbc, (E, nu, dens, dt, nsteps), probes = _cases()[name]
        bf = _pulse if name == "2d" else _constant
        run = lambda dtype: explicit_dynamics_sharded(
            mesh, dbc, E, nu, dens, dt, nsteps, bforce_fn=bf,
            probe_dofs=probes, dtype=dtype, device="cpu")
        r64, a, b = run(torch.float64), run(torch.float32), \
            run(torch.float32)
        for f in FIELDS:
            out[f"{name} {f}"] = getattr(r64, f)
            out[f"{name} {f} f32"] = getattr(a, f)
            out[f"{name} {f} f32 again"] = getattr(b, f)
        setup = build_sharded_explicit(mesh, mesh.ndim, dbc, size, rank,
                                       probes)
        out[f"{name} halo"] = setup.halo
        out[f"{name} rows"] = setup.rows_per_shard
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


@functools.lru_cache(maxsize=None)
def _jax(name, n):
    import jax
    import jax.numpy as jnp
    from pfemfort_tpu.dynamics.sharded import build_sharded_explicit as jb
    from pfemfort_tpu.dynamics.sharded import \
        explicit_dynamics_sharded as j_run
    from pfemfort_tpu.mesh import generate as jgen

    mesh, dbc, (E, nu, dens, dt, nsteps), probes = _cases(jgen)[name]
    if name == "2d":
        bf = lambda t: jnp.stack([jnp.where(t <= 0.1, 1.0, 0.0),
                                  jnp.zeros(())])
    else:
        bf = lambda t: jnp.asarray([1.0, 0.0, 0.0])
    dm = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("shard",))
    res = j_run(mesh, dbc, E, nu, dens, dt, nsteps, device_mesh=dm,
                bforce_fn=bf, probe_dofs=probes)
    return res, jb(mesh, mesh.ndim, dbc, n, probes)


CASES = [(2, "2d"), (4, "2d"), (4, "3d")]
TOL = {"2d": dict(disp=(1e-9, 1e-12), velo=(1e-9, 1e-12),
                  acce=(1e-9, 1e-10), probe_history=(1e-9, 1e-12)),
       "3d": dict(disp=(1e-8, 1e-12), velo=(1e-8, 1e-12),
                  acce=(1e-8, 1e-9), probe_history=(1e-8, 1e-12))}


@pytest.mark.parametrize("size,name", CASES)
def test_sharded_explicit_matches_jax(ranks, size, name):
    ref, setup = _jax(name, size)
    for r in ranks[size]:
        assert int(r[f"{name} halo"]) == setup.halo
        assert int(r[f"{name} rows"]) == setup.rows_per_shard
        for f in FIELDS:
            rtol, atol = TOL[name][f]
            np.testing.assert_allclose(r[f"{name} {f}"], getattr(ref, f),
                                       rtol=rtol, atol=atol, err_msg=f)
    assert np.abs(ranks[size][0][f"{name} acce"]).max() > 0


@pytest.mark.parametrize("size,name", CASES)
def test_float32_repeats_bit_for_bit_on_every_rank(ranks, size, name):
    first = ranks[size][0]
    for r in ranks[size]:
        for f in FIELDS:
            np.testing.assert_array_equal(r[f"{name} {f} f32"],
                                          r[f"{name} {f} f32 again"])
            np.testing.assert_array_equal(r[f"{name} {f} f32"],
                                          first[f"{name} {f} f32"])
        assert np.isfinite(r[f"{name} disp f32"]).all()


if __name__ == "__main__":      # one rank, as the `ranks` fixture starts it
    multihost.initialize(device="cpu")
    try:
        _ranks(sys.argv[1])
    finally:
        multihost.shutdown()
