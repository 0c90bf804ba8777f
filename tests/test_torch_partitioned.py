"""Port parity: the per-rank-file input mode (mesh/io.py:write_partitioned,
read_partitioned; drivers/partitioned.py), the reference's
triapoissonparallelimpl2.

In this process: the files `write_partitioned` writes are byte-identical to
the JAX package's, for a slab and an RCB partition, and the port reads
them back (one rank's files, and all of them merged) as the JAX package
does.  Then two gloo ranks (this file run as a script under torchrun; the
rank processes never import JAX) on a scrambled box written in two RCB
parts: `read_partitioned_multiprocess`, each rank reading only its own
files, gives the JAX package's `read_partitioned_local` mesh and BCs, and
`solve_poisson_partitioned(multiprocess=True)` matches the JAX package's
`solve_poisson_partitioned` (float64: u within 1e-10, the same count, the
ELL route).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pfemfort_tpu_torch.drivers.partitioned import \
    read_partitioned_local, read_partitioned_multiprocess, \
    solve_poisson_partitioned
from pfemfort_tpu_torch.mesh import generate, io as mesh_io
from pfemfort_tpu_torch.parallel import multihost

RANKS = 2
SUFFIXES = ("nodes", "elems", "DirichBC", "gids")


def _scrambled(gen=generate):
    mesh, dbc = gen.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 12)
    perm = np.random.default_rng(5).permutation(mesh.n_node)
    mesh = mesh.renumbered(perm.astype(np.int64))
    dbc = dbc.copy()
    dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    return mesh, dbc


def _same_mesh(a, b):
    assert a.etype == b.etype
    np.testing.assert_array_equal(a.coords, b.coords)
    np.testing.assert_array_equal(a.conn, b.conn)


@pytest.mark.parametrize("method,n_parts", [("slab", 3), ("rcb", 4)])
def test_write_partitioned_files_equal_jax(tmp_path, method, n_parts):
    from pfemfort_tpu.mesh import generate as jgen
    from pfemfort_tpu.mesh import io as jio

    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    mesh, dbc = generate.box_tet(0, 1, 3, 0, 1, 3, 0, 2, 6)
    jmesh, jdbc = jgen.box_tet(0, 1, 3, 0, 1, 3, 0, 2, 6)
    part = mesh_io.write_partitioned(str(tmp_path / "t" / "p"), mesh,
                                     n_parts, dirichlet=dbc, method=method)
    jpart = jio.write_partitioned(str(tmp_path / "j" / "p"), jmesh, n_parts,
                                  dirichlet=jdbc, method=method)
    np.testing.assert_array_equal(part, jpart)
    assert set(np.unique(part).tolist()) == set(range(n_parts))
    for k in range(n_parts):
        for suffix in SUFFIXES:
            name = f"p-p{k}-{suffix}.dat"
            assert (tmp_path / "t" / name).read_bytes() \
                == (tmp_path / "j" / name).read_bytes(), name


def test_read_partitioned_equals_jax(tmp_path):
    from pfemfort_tpu.drivers.partitioned import \
        read_partitioned_local as j_local
    from pfemfort_tpu.mesh import io as jio

    mesh, dbc = _scrambled()
    prefix = str(tmp_path / "p")
    mesh_io.write_partitioned(prefix, mesh, 3, dirichlet=dbc, method="rcb")
    for k in range(3):
        sub, dbc_k, gids = mesh_io.read_partitioned(prefix, k)
        jsub, jdbc_k, jgids = jio.read_partitioned(prefix, k)
        _same_mesh(sub, jsub)
        np.testing.assert_array_equal(dbc_k, jdbc_k)
        np.testing.assert_array_equal(gids, jgids)
    merged, mdbc = read_partitioned_local(prefix, range(3))
    jmerged, jmdbc = j_local(prefix, range(3))
    _same_mesh(merged, jmerged)
    np.testing.assert_array_equal(mdbc, jmdbc)
    assert merged.n_node == mesh.n_node and merged.n_elem == mesh.n_elem


def _ranks(prefix, outdir):
    import torch.distributed as dist

    assert "jax" not in sys.modules
    rank = dist.get_rank()
    mesh, dbc = read_partitioned_multiprocess(prefix)
    _, res = solve_poisson_partitioned(prefix, RANKS, multiprocess=True,
                                       dtype=torch.float64, rtol=1e-8,
                                       recover=False, device="cpu")
    np.savez(Path(outdir) / f"rank{rank}.npz", coords=mesh.coords,
             conn=mesh.conn, dbc=dbc, u=res.u_full, iters=res.stats.iters,
             layout=res.timings["assembly_layout"])
    assert "jax" not in sys.modules


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("partitioned")
    prefix = str(d / "mhu")
    mesh, dbc = _scrambled()
    mesh_io.write_partitioned(prefix, mesh, RANKS, dirichlet=dbc,
                              method="rcb")
    rc = multihost.torchrun_ranks([__file__, prefix, str(d)], RANKS,
                                  timeout=300)
    assert rc == 0
    return prefix, [dict(np.load(d / f"rank{r}.npz")) for r in range(RANKS)]


def test_multiprocess_read_equals_jax(ranks):
    from pfemfort_tpu.drivers.partitioned import \
        read_partitioned_local as j_local

    prefix, out = ranks
    jmesh, jdbc = j_local(prefix, range(RANKS))
    for r in out:
        np.testing.assert_array_equal(r["coords"], jmesh.coords)
        np.testing.assert_array_equal(r["conn"], jmesh.conn)
        np.testing.assert_array_equal(r["dbc"], jdbc)


def test_solve_poisson_partitioned_matches_jax(ranks):
    import jax
    from pfemfort_tpu.drivers.partitioned import \
        solve_poisson_partitioned as j_solve

    prefix, out = ranks
    dm = jax.sharding.Mesh(np.array(jax.devices()[:RANKS]), ("shard",))
    mesh, ref = j_solve(prefix, RANKS, device_mesh=dm, rtol=1e-8,
                        recover=False)
    assert ref.timings["assembly_layout"] == "ell"
    for r in out:
        assert str(r["layout"]) == "ell"
        assert int(r["iters"]) == int(np.asarray(ref.stats.iters))
        np.testing.assert_allclose(r["u"], ref.u_full, rtol=0, atol=1e-10)
    assert np.abs(out[0]["u"] - (mesh.coords ** 2).sum(1)).max() < 1e-6


if __name__ == "__main__":      # one rank, as the `ranks` fixture starts it
    multihost.initialize(device="cpu")
    try:
        _ranks(sys.argv[1], sys.argv[2])
    finally:
        multihost.shutdown()
