"""Port parity: the distributed SA-AMG (solve/amg.py:build_dist_samg,
dist_samg_preconditioner) on the sharded ELL route, on 2, 4 and 8 gloo
ranks.

The case is the multichip dry run's: box_tet 12x12x16 with its nodes
permuted by default_rng(5), Poisson, float64, recover=False.  Before each
world size is launched, this process builds the JAX package's hierarchy of
that world size's shard-ordered system (its build_dist_samg on its own
assembly) and applies JAX's dist_samg_preconditioner once to a seeded
vector.  Each world size is then launched once (this file run as a script
under torchrun; the ranks never import JAX), and every rank:
  * builds its share of the hierarchy through drivers/sharded.py's set-up
    (values all-gathered, cast to float64): the level sizes are JAX's and
    its P0 row block is JAX's within 1e-12;
  * applies dist_samg_preconditioner built on JAX's hierarchy
    (interop.dist_samg_from_numpy) with its own ghost-exchange operator:
    within 1e-12 of JAX's application;
  * forms the coarse residual (one all_reduce of its P0_s^T product) and
    the tail's correction: the same bits on every rank;
  * solves through solve_implicit_sharded(precond='amg'): u within 1e-10
    of JAX's solve with the same iteration count;
  * solves tests/test_amg.py's 3D elasticity case on a box_tet 8x8x10
    (default_rng(2), a linear field on the boundary, rtol 1e-10) with the
    rigid-body near-nullspace: u within 1e-7 of the linear field and 1e-8
    of JAX's, fewer than 0.4x Jacobi's iterations, JAX's count;
  * solves tests/test_amg.py's shard-invariance mesh (box_tet 14^3,
    default_rng(3), rtol 1e-10), which this process also solves at world
    size 1: the JAX test's bar (counts within 2, u within 5e-8).
"""

import functools
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pfemfort_tpu_torch.drivers import sharded as t_sharded
from pfemfort_tpu_torch.drivers.sharded import solve_implicit_sharded
from pfemfort_tpu_torch.elements.elasticity import dmat_3d, \
    elasticity_stiffness
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
from pfemfort_tpu_torch.mesh import generate
from pfemfort_tpu_torch.parallel import multihost
from pfemfort_tpu_torch.parallel.shard_cg import _gathered

WORLDS = (2, 4, 8)
F64 = torch.float64
TAIL_FIELDS = ("a_cols", "a_vals", "p_cols", "p_vals", "pt_cols", "pt_vals",
               "p0_cols", "p0_vals", "p0t_cols", "p0t_vals", "inv_diags")


def _poisson(c, fn=poisson_element_matrices):
    return fn(c, "tetra4", source=-6.0)


def _scrambled(dims, seed, gen=generate):
    mesh, dbc = gen.box_tet(0, 1, dims[0], 0, 1, dims[1], 0, 1, dims[2])
    perm = np.random.default_rng(seed).permutation(mesh.n_node)
    mesh = mesh.renumbered(perm.astype(np.int64))
    dbc = dbc.copy()
    dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    return mesh, dbc


def _linear_field(X):
    return np.stack([0.1 * X[:, 0], 0.05 * X[:, 1], -0.03 * X[:, 2]], axis=1)


def _elastic_case(gen=generate):
    """tests/test_amg.py's elasticity case on a box_tet 8x8x10: 1,323 free
    rows, so the hierarchy coarsens at every rank count (the JAX test's
    6x6x10 has 675, under the 800-row coarsest level: it stays Jacobi at
    2 ranks in both packages)."""
    mesh, _ = gen.box_tet(0, 1, 8, 0, 1, 8, 0, 1, 10)
    perm = np.random.default_rng(2).permutation(mesh.n_node)
    mesh = mesh.renumbered(perm.astype(np.int64))
    bnodes = gen.boundary_nodes(mesh)
    ub = _linear_field(mesh.coords[bnodes])
    dbc = np.concatenate([
        np.stack([bnodes, np.full(len(bnodes), d), ub[:, d]], axis=1)
        for d in range(3)])
    return mesh, dbc


def _elastic_fn(D_fn=dmat_3d, fn=elasticity_stiffness):
    D = D_fn(210.0, 0.3)
    return lambda c: fn(c, "tetra4", D)


CASE = ((12, 12, 16), 5)
INVARIANT = ((14, 14, 14), 3)


def _seeded(n, seed=11):
    return np.random.default_rng(seed).standard_normal(n)


def _ranks(outdir):
    import torch.distributed as dist

    from pfemfort_tpu_torch.interop import dist_samg_from_numpy
    from pfemfort_tpu_torch.parallel.dist_ell import build_dist_ell_setup, \
        build_ell_halo, spmv_ell_halo
    from pfemfort_tpu_torch.solve.amg import dist_samg_preconditioner
    from pfemfort_tpu_torch.solve.amg_device import _vcycle_device
    from pfemfort_tpu_torch.sparse.ell_spmv_cuda import ell_spmv
    from pfemfort_tpu_torch.sparse.sliced import slice_ell, unslice

    assert "jax" not in sys.modules
    rank, size = dist.get_rank(), dist.get_world_size()
    out = {}
    mesh, dbc = _scrambled(*CASE)
    setup = build_dist_ell_setup(mesh, 1, dbc, size, rank, device="cpu")
    halo = build_ell_halo(setup.sys, rank, device="cpu")
    vals, _ = t_sharded.assemble_implicit_sharded_ell(setup, _poisson, F64,
                                                      "cpu")
    amg, _ = t_sharded._dist_samg(setup.sys, mesh, 1, vals, F64, "cpu")
    out["sizes"] = np.asarray(amg.metas[0].sizes)
    p0 = unslice(amg.p0)
    out["p0_cols"], out["p0_vals"] = p0.cols.numpy(), p0.vals.numpy()

    A_l = slice_ell(halo.cols_local, halo.n_cols).pack(vals)
    op = lambda x: spmv_ell_halo(A_l, halo, x)
    rows = torch.arange(vals.shape[0])[:, None]
    d = torch.where(halo.cols_local.long() == rows, vals, 0).sum(1)
    inv_d = torch.where(d != 0, 1.0 / d, 0.0)
    j = dict(np.load(Path(outdir) / "jax_amg.npz"))
    levels = lambda f: [j[f"{f}{i}"] for i in range(len(j))
                        if f"{f}{i}" in j]
    tail = SimpleNamespace(**{f: levels(f) for f in TAIL_FIELDS},
                           omegas=j["omegas"], coarse_inv=j["coarse_inv"])
    metas = tuple(SimpleNamespace(sizes=j[f"sizes{m}"], nu=int(j["nu"]),
                                  omega_smooth=float(j["omega_smooth"]))
                  for m in (0, 1))
    amg_j = dist_samg_from_numpy(j["p0_cols_s"], j["p0_vals_s"], j["om0"],
                                 tail, metas, rank, device="cpu", dtype=F64)
    P = vals.shape[0]
    r = torch.as_tensor(_seeded(size * P)[rank * P:(rank + 1) * P])
    out["z"] = _gathered(dist_samg_preconditioner(amg_j, inv_d, op)(r)
                         ).numpy()
    rc = ell_spmv(amg.p0t, r)
    dist.all_reduce(rc)
    out["rc"] = rc.numpy()
    out["ec"] = _vcycle_device(amg.tail, amg.metas[1], 0, rc, None).numpy()

    res = solve_implicit_sharded(mesh, 1, dbc, _poisson, dtype=F64,
                                 rtol=1e-8, maxiter=60, recover=False,
                                 precond="amg", device="cpu")
    out["u"], out["iters"] = res.u_full, res.stats.iters
    out["used"] = res.timings["precond_used"]
    out["layout"] = res.timings["assembly_layout"]
    out["levels"] = np.asarray(res.timings["amg_levels"])

    m, d = _elastic_case()
    for pc in ("amg", "jacobi"):
        res = solve_implicit_sharded(m, 3, d, _elastic_fn(), dtype=F64,
                                     rtol=1e-10, recover=False, precond=pc,
                                     device="cpu")
        out[f"el u {pc}"], out[f"el iters {pc}"] = res.u_full, \
            res.stats.iters
        out[f"el converged {pc}"] = res.stats.converged
        out[f"el used {pc}"] = res.timings["precond_used"]

    m, d = _scrambled(*INVARIANT)
    res = solve_implicit_sharded(m, 1, d, _poisson, dtype=F64, rtol=1e-10,
                                 recover=False, precond="amg", device="cpu")
    out["inv u"], out["inv iters"] = res.u_full, res.stats.iters
    out["inv used"] = res.timings["precond_used"]
    np.savez(Path(outdir) / f"rank{rank}.npz", **out)
    assert "jax" not in sys.modules


def _device_mesh(n):
    import jax

    return jax.sharding.Mesh(np.array(jax.devices()[:n]), ("shard",))


@functools.lru_cache(maxsize=None)
def _jax_hierarchy(n):
    """JAX's distributed hierarchy of the n-shard system, as the npz the
    ranks read, and its preconditioner applied to the seeded vector."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from pfemfort_tpu.assembly.assemble import assemble_ell_values
    from pfemfort_tpu.elements.geometry import to_element_minor
    from pfemfort_tpu.elements.poisson import poisson_element_matrices as jp
    from pfemfort_tpu.mesh import generate as jgen
    from pfemfort_tpu.parallel.shard import build_sharded_system
    from pfemfort_tpu.solve.amg import _ell_mv, build_dist_samg, \
        dist_samg_preconditioner
    from pfemfort_tpu.solve.amg_device import build_samg_device

    mesh, dbc = _scrambled(*CASE, gen=jgen)
    sys_ = build_sharded_system(mesh, 1, dbc, n, method="rcb", layout="ell")
    pat = sys_.pattern
    Ke, _ = _poisson(jnp.asarray(to_element_minor(mesh.elem_coords())), jp)
    A = assemble_ell_values(Ke, pat, jnp.asarray(pat.ell_cols))
    vals = np.asarray(A.vals, dtype=np.float64)
    deg = np.diff(pat.indptr)
    within = np.arange(pat.nnz) - np.repeat(pat.indptr[:-1], deg)
    csr_row = np.repeat(np.arange(pat.n_rows), deg)
    dist_amg, metas = build_dist_samg(pat.indptr, pat.indices,
                                      vals[csr_row, within],
                                      sys_.n_rows_padded, n,
                                      dtype=jnp.float64)
    tail = dist_amg.tail
    sizes = metas[1].sizes
    tail_dev = build_samg_device(tail, sizes, dtype=jnp.float64)
    cols = jnp.asarray(A.cols)
    rows = jnp.arange(cols.shape[0])[:, None]
    d = jnp.sum(jnp.where(cols == rows, A.vals, 0), axis=1)
    inv_d = jnp.where(d != 0, 1.0 / d, 0.0)
    N = sys_.n_rows_padded
    pc_cols = jnp.asarray(dist_amg.p0_cols_s).reshape(N, -1)
    pc_vals = jnp.asarray(dist_amg.p0_vals_s).reshape(N, -1)

    def body(r):
        pc = dist_samg_preconditioner(
            pc_cols, pc_vals, dist_amg.om0, tail_dev, metas, inv_d,
            lambda x: _ell_mv(cols, A.vals, x), "shard")
        return pc(r)

    z = jax.jit(jax.shard_map(body, mesh=_device_mesh(1), in_specs=P(),
                              out_specs=P(), check_vma=False))(
        jnp.asarray(_seeded(N)))
    npz = dict(p0_cols_s=np.asarray(dist_amg.p0_cols_s),
               p0_vals_s=np.asarray(dist_amg.p0_vals_s), om0=dist_amg.om0,
               omegas=np.asarray(tail.omegas),
               coarse_inv=np.asarray(tail.coarse_inv), nu=metas[0].nu,
               omega_smooth=metas[0].omega_smooth,
               sizes0=np.asarray(metas[0].sizes),
               sizes1=np.asarray(metas[1].sizes))
    for f in TAIL_FIELDS:
        for i, a in enumerate(getattr(tail, f)):
            npz[f"{f}{i}"] = np.asarray(a)
    return npz, np.asarray(z)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = {}
    for size in WORLDS:
        d = tmp_path_factory.mktemp(f"world{size}")
        np.savez(d / "jax_amg.npz", **_jax_hierarchy(size)[0])
        rc = multihost.torchrun_ranks([__file__, str(d)], size, timeout=300)
        assert rc == 0
        out[size] = [dict(np.load(d / f"rank{r}.npz"))
                     for r in range(size)]
    return out


def _dense(cols, vals, n_cols):
    out = np.zeros((cols.shape[0], n_cols + 1))
    np.add.at(out, (np.arange(cols.shape[0])[:, None]
                    .repeat(cols.shape[1], 1), cols), vals)
    return out[:, :n_cols]


@pytest.mark.parametrize("size", WORLDS)
def test_hierarchy_levels_and_p0_blocks_match_jax(ranks, size):
    npz, _ = _jax_hierarchy(size)
    n_c = int(npz["sizes1"][0])
    for rank, r in enumerate(ranks[size]):
        np.testing.assert_array_equal(r["sizes"], npz["sizes0"])
        np.testing.assert_allclose(
            _dense(r["p0_cols"], r["p0_vals"], n_c),
            _dense(npz["p0_cols_s"][rank], npz["p0_vals_s"][rank], n_c),
            rtol=0, atol=1e-12)


@pytest.mark.parametrize("size", WORLDS)
def test_preconditioner_on_the_jax_hierarchy_matches_jax(ranks, size):
    _, z = _jax_hierarchy(size)
    for r in ranks[size]:
        np.testing.assert_allclose(r["z"], z, rtol=0, atol=1e-12)


@pytest.mark.parametrize("size", WORLDS)
def test_coarse_residual_and_tail_have_the_same_bits_on_every_rank(ranks,
                                                                   size):
    first = ranks[size][0]
    assert np.abs(first["ec"]).max() > 0
    for r in ranks[size][1:]:
        np.testing.assert_array_equal(r["rc"], first["rc"])
        np.testing.assert_array_equal(r["ec"], first["ec"])


@functools.lru_cache(maxsize=None)
def _jax_solve(case, n):
    import jax.numpy as jnp
    from pfemfort_tpu.drivers.sharded import solve_implicit_sharded as j_solve
    from pfemfort_tpu.elements import elasticity as jel
    from pfemfort_tpu.elements.poisson import poisson_element_matrices as jp
    from pfemfort_tpu.mesh import generate as jgen

    if case == "poisson":
        mesh, dbc = _scrambled(*CASE, gen=jgen)
        return mesh, j_solve(mesh, 1, dbc, lambda c: _poisson(c, jp),
                             device_mesh=_device_mesh(n), dtype=jnp.float64,
                             rtol=1e-8, maxiter=60, recover=False,
                             precond="amg")
    mesh, dbc = _elastic_case(jgen)
    return mesh, j_solve(mesh, 3, dbc,
                         _elastic_fn(jel.dmat_3d, jel.elasticity_stiffness),
                         device_mesh=_device_mesh(n), dtype=jnp.float64,
                         rtol=1e-10, recover=False, precond="amg")


@pytest.mark.parametrize("size", WORLDS)
def test_amg_solve_matches_jax(ranks, size):
    mesh, ref = _jax_solve("poisson", size)
    assert ref.timings["precond_used"] == "amg"
    for r in ranks[size]:
        assert str(r["used"]) == "amg" and str(r["layout"]) == "ell"
        np.testing.assert_array_equal(r["levels"], r["sizes"])
        assert int(r["iters"]) == int(np.asarray(ref.stats.iters))
        np.testing.assert_allclose(r["u"], ref.u_full, rtol=0, atol=1e-10)
    assert np.abs(ranks[size][0]["u"]
                  - (mesh.coords ** 2).sum(axis=1)).max() < 1e-4


@pytest.mark.parametrize("size", WORLDS)
def test_elasticity_amg_with_rigid_body_modes(ranks, size):
    mesh, ref = _jax_solve("elasticity", size)
    ue = _linear_field(mesh.coords).reshape(-1)
    for r in ranks[size]:
        assert str(r["el used amg"]) == ref.timings["precond_used"] == "amg"
        assert bool(r["el converged amg"]) and bool(r["el converged jacobi"])
        assert int(r["el iters amg"]) < 0.4 * int(r["el iters jacobi"])
        assert int(r["el iters amg"]) == int(np.asarray(ref.stats.iters))
        np.testing.assert_allclose(r["el u amg"], ref.u_full, rtol=0,
                                   atol=1e-8)
        assert np.abs(r["el u amg"] - ue).max() < 1e-7


@pytest.fixture(scope="module")
def world1():
    multihost.initialize(device="cpu")
    yield
    multihost.shutdown()


def test_one_rank_and_eight_ranks_give_the_same_solve(ranks, world1):
    mesh, dbc = _scrambled(*INVARIANT)
    one = solve_implicit_sharded(mesh, 1, dbc, _poisson, dtype=F64,
                                 rtol=1e-10, recover=False, precond="amg",
                                 device="cpu")
    assert one.timings["precond_used"] == "amg" and one.stats.converged
    for r in ranks[8]:
        assert str(r["inv used"]) == "amg"
        assert abs(int(r["inv iters"]) - one.stats.iters) <= 2
        np.testing.assert_allclose(r["inv u"], one.u_full, rtol=0,
                                   atol=5e-8)


if __name__ == "__main__":      # one rank, as the `ranks` fixture starts it
    multihost.initialize(device="cpu")
    try:
        _ranks(sys.argv[1])
    finally:
        multihost.shutdown()
