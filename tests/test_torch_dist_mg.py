"""Port parity: the distributed geometric multigrid (parallel/dist_mg.py)
on 2, 4 and 8 gloo ranks.

Each world size is launched once (this file run as a script under
torchrun; the ranks never import JAX).  Every rank:
  * builds its block of `build_dist_mg_setup` on tests/test_dist_mg.py's
    8x8x16 box (Poisson, float64): coords, validz, BC mask and values are
    the JAX setup's rows of that rank, bit for bit;
  * assembles its fine block (`assemble_fine_shard`: the spill pair and
    the symmetric elimination) and applies `dist_gmg_preconditioner` once
    to a seeded vector: the fine block, rhs and gathered result within
    1e-12 of the JAX package's shard_map run; the replicated coarse
    correction of a seeded residual has the same bits on every rank;
  * solves through `solve_implicit_sharded(precond='mg')`: the 8x8x16 box
    and the uneven 6x6x10 box (padding planes on the last ranks) with u
    within 1e-10 of JAX's solve and the same iteration count;
  * solves a box whose coarse lattice stalls on odd cell counts above the
    dense inverse's size, so the coarse tail is the Chebyshev polynomial
    (the JAX test's bars);
  * solves the JAX test's own Chebyshev-tail case through
    `solve_sharded_mg(..., coarsest_max_dof=50)` (a 12^3 box whose 4^3
    coarse lattice stays above the cap): JAX's iteration count and u within
    1e-10 of JAX's;
  * solves the 3D elasticity box with the smoothing passed explicitly
    (nu = 1, omega = 0.8, the keywords of JAX's `solve_sharded_mg`): JAX's
    count and u within 1e-10 of JAX's run with the same keywords;
  * solves tests/test_dist_mg.py's 3D elasticity box (a linear field on
    the boundary) with the port's vector smoothing (nu = 2, omega from the
    fine level's lambda_max): converged, fewer iterations than the sharded
    Jacobi solve of the same system, u within 1e-8 of JAX's (both at rtol
    1e-10; JAX smooths with its own (2, 0.6));
  * takes the JAX package's fall-backs: precond='mg' on an odd box, with
    ForceBCs and on a renumbered box without its structure runs Jacobi and
    records `mg_refused`, with JAX's reason, counts and u.
In this process, at world size 1 (a one-rank gloo group): the fine-level
weight equals solve/multigrid.py:_jacobi_weight's to 1e-12, and the port's
preconditioner built on the JAX package's own setup
(interop.dist_mg_setup_from_numpy) matches JAX's to 1e-12.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pfemfort_tpu_torch.drivers.sharded import solve_implicit_sharded
from pfemfort_tpu_torch.elements.elasticity import dmat_3d, \
    elasticity_stiffness
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
from pfemfort_tpu_torch.mesh import generate
from pfemfort_tpu_torch.parallel import dist_mg, multihost
from pfemfort_tpu_torch.parallel.shard_cg import _gathered

WORLDS = (2, 4, 8)
F64 = torch.float64
SOLVES = {"8x8x16": (8, 8, 16), "6x6x10": (6, 6, 10)}


def _poisson(c, fn=poisson_element_matrices):
    return fn(c, "tetra4", source=-6.0)


def _linear_field(X):
    return np.stack([0.1 * X[:, 0], 0.05 * X[:, 1] + 0.02 * X[:, 0],
                     -0.03 * X[:, 2]], axis=1)


def _elastic_case(gen=generate):
    """tests/test_dist_mg.py's ndof=3 case: box 4x4x8, the linear field on
    every boundary node."""
    mesh, _ = gen.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 8)
    bnodes = gen.boundary_nodes(mesh)
    ub = _linear_field(mesh.coords[bnodes])
    dbc = np.concatenate([
        np.stack([bnodes, np.full(len(bnodes), d), ub[:, d]], axis=1)
        for d in range(3)])
    return mesh, dbc


def _elastic_fn(D_fn=dmat_3d, fn=elasticity_stiffness):
    D = D_fn(210.0, 0.3)
    return lambda c: fn(c, "tetra4", D)


def _refused_cases(gen=generate):
    """name -> (mesh, dbc, force_bc, solve keywords) of meshes the
    distributed MG refuses: an odd cell count, ForceBCs, and a renumbered
    box without its structure (recover=False)."""
    odd, odd_dbc = gen.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 7)
    box, box_dbc = gen.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 8)
    centre = int(np.argmin(((box.coords - 0.5) ** 2).sum(axis=1)))
    fbc = np.array([[centre, 0, 0.25]])
    sc, sc_dbc = gen.box_tet(0, 1, 5, 0, 1, 5, 0, 1, 8)
    perm = np.random.default_rng(0).permutation(sc.n_node)
    sc = sc.renumbered(perm.astype(np.int64))
    sc_dbc = sc_dbc.copy()
    sc_dbc[:, 0] = perm[sc_dbc[:, 0].astype(np.int64)]
    kw = dict(rtol=1e-10, maxiter=500)
    return {"odd": (odd, odd_dbc, None, kw),
            "forced": (box, box_dbc, fbc, kw),
            "renumbered": (sc, sc_dbc, None, dict(kw, recover=False))}


def _residual(n, seed=7):
    return np.random.default_rng(seed).standard_normal(n)


def _ranks(outdir):
    import torch.distributed as dist

    assert "jax" not in sys.modules
    rank, size = dist.get_rank(), dist.get_world_size()
    out = {}
    mesh, dbc = generate.box_tet(0, 1, 8, 0, 1, 8, 0, 1, 16)
    setup = dist_mg.build_dist_mg_setup(mesh, 1, dbc, _poisson, size, rank,
                                        dtype=F64, device="cpu")
    for f in ("coords", "validz", "bc_mask", "bc_vals"):
        out[f] = getattr(setup, f)
    as_t = lambda a: torch.as_tensor(a, dtype=F64)
    bc_l = torch.as_tensor(setup.bc_mask)
    vals_l, b_l = dist_mg.assemble_fine_shard(
        setup, _poisson, as_t(setup.coords), as_t(setup.validz), bc_l,
        as_t(setup.bc_vals))
    out["vals"], out["b"] = vals_l.numpy(), b_l.numpy()
    diag = vals_l[setup.offsets.index(0)]
    spmv = dist_mg.fine_spmv_factory(setup, vals_l)
    pc = dist_mg.dist_gmg_preconditioner(
        setup, torch.where(diag != 0, 1.0 / diag, 0.0),
        torch.where(bc_l, 0.0, 1.0).to(F64), setup.coarse[0], spmv)
    P = setup.rows_per_shard
    r = as_t(_residual(size * P)[rank * P:(rank + 1) * P])
    out["z"] = _gathered(pc(r)).numpy()
    r_lat = r.reshape(setup.planes_per_shard, setup.nny, setup.nnx, 1)
    rc = dist_mg.gathered_coarse_residual(
        setup, dist_mg.restrict_shard(setup, r_lat))
    out["ec"] = dist_mg.coarse_solver(setup, setup.coarse[0])(rc).numpy()

    for name, dims in SOLVES.items():
        m, d = generate.box_tet(0, 1, dims[0], 0, 1, dims[1], 0, 1, dims[2])
        res = solve_implicit_sharded(m, 1, d, _poisson, dtype=F64,
                                     rtol=1e-8, maxiter=60, precond="mg",
                                     device="cpu")
        out[f"u {name}"], out[f"iters {name}"] = res.u_full, res.stats.iters
        out[f"mg {name}"] = res.timings["distributed_mg"]

    m, d = generate.box_tet(0, 1, 30, 0, 1, 30, 0, 1, 34)
    res = solve_implicit_sharded(m, 1, d, _poisson, dtype=F64, rtol=1e-8,
                                 maxiter=60, precond="mg", device="cpu")
    out["cheby u"], out["cheby iters"] = res.u_full, res.stats.iters
    out["cheby converged"] = res.stats.converged
    out["cheby levels"] = res.timings["mg_levels"]

    m, d = generate.box_tet(0, 1, 12, 0, 1, 12, 0, 1, 12)
    u, st, tm = dist_mg.solve_sharded_mg(m, 1, d, _poisson, dtype=F64,
                                         rtol=1e-8, maxiter=60,
                                         coarsest_max_dof=50, device="cpu")
    out["tail u"], out["tail iters"] = u, st.iters
    out["tail converged"], out["tail levels"] = st.converged, \
        tm["mg_levels"]

    m, d = _elastic_case()
    u, st, tm = dist_mg.solve_sharded_mg(m, 3, d, _elastic_fn(), dtype=F64,
                                         rtol=1e-10, maxiter=200, nu=1,
                                         omega=0.8, device="cpu")
    out["el given u"], out["el given iters"] = u, st.iters
    out["el given smoothing"] = (tm["mg_nu"], tm["mg_omega"])
    for pc_name in ("mg", "jacobi"):
        res = solve_implicit_sharded(m, 3, d, _elastic_fn(), dtype=F64,
                                     rtol=1e-10, precond=pc_name,
                                     device="cpu")
        out[f"el u {pc_name}"] = res.u_full
        out[f"el iters {pc_name}"] = res.stats.iters
        out[f"el converged {pc_name}"] = res.stats.converged
        out[f"el used {pc_name}"] = res.timings["precond_used"]
        out[f"el omega {pc_name}"] = res.timings.get("mg_omega", -1.0)

    for case, (m, d, f, kw) in _refused_cases().items():
        res = solve_implicit_sharded(m, 1, d, _poisson, force_bc=f,
                                     dtype=F64, precond="mg", device="cpu",
                                     **kw)
        out[f"{case} u"], out[f"{case} iters"] = res.u_full, res.stats.iters
        out[f"{case} used"] = res.timings["precond_used"]
        out[f"{case} refused"] = res.timings["mg_refused"]
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


def _device_mesh(n):
    import jax

    return jax.sharding.Mesh(np.array(jax.devices()[:n]), ("shard",))


def _jax_setup(n, dims=(8, 8, 16)):
    import jax.numpy as jnp
    from pfemfort_tpu.elements.poisson import poisson_element_matrices as jp
    from pfemfort_tpu.mesh import generate as jgen
    from pfemfort_tpu.parallel.dist_mg import build_dist_mg_setup

    mesh, dbc = jgen.box_tet(0, 1, dims[0], 0, 1, dims[1], 0, 1, dims[2])
    efn = lambda c: _poisson(c, jp)
    return build_dist_mg_setup(mesh, 1, dbc, efn, n, dtype=jnp.float64), efn


@functools.lru_cache(maxsize=None)
def _jax_fine(n):
    """JAX's per-shard fine blocks, rhs and one preconditioner application
    (gathered) on the seeded vector, through its shard_map."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from pfemfort_tpu.parallel import dist_mg as jdm

    setup, efn = _jax_setup(n)
    dm = _device_mesh(n)
    put = lambda a, spec: jax.device_put(a, NamedSharding(dm, spec))

    def body(coords_b, validz_b, bc_l, bcv_l, ca, r_l):
        vals_l, b_l = jdm._assemble_fine_shard(
            setup, efn, coords_b[0], validz_b[0], bc_l, bcv_l, "shard")
        diag = vals_l[setup.offsets.index(0)]
        inv = jnp.where(diag != 0, 1.0 / diag, 0.0)
        mask = jnp.where(bc_l, 0.0, 1.0).astype(vals_l.dtype)
        pc = jdm.dist_gmg_preconditioner(setup, vals_l, inv, mask, ca,
                                         "shard")
        return vals_l, b_l, jax.lax.all_gather(pc(r_l), "shard", tiled=True)

    mapped = jax.shard_map(
        body, mesh=dm,
        in_specs=(P("shard"),) * 4 + (P(), P("shard")),
        out_specs=(P(None, "shard"), P("shard"), P()), check_vma=False)
    vals, b, z = jax.jit(mapped)(
        put(jnp.asarray(setup.coords_s), P("shard")),
        put(jnp.asarray(setup.validz_s), P("shard")),
        put(jnp.asarray(setup.bc_mask_pad), P("shard")),
        put(jnp.asarray(setup.bc_vals_pad), P("shard")),
        setup.coarse[0],
        put(jnp.asarray(_residual(setup.n_rows_padded)), P("shard")))
    return setup, np.asarray(vals), np.asarray(b), np.asarray(z)


@pytest.mark.parametrize("size", WORLDS)
def test_setup_rows_equal_jax(ranks, size):
    setup, _ = _jax_setup(size)
    P = setup.rows_per_shard
    for rank, r in enumerate(ranks[size]):
        np.testing.assert_array_equal(r["coords"], setup.coords_s[rank])
        np.testing.assert_array_equal(r["validz"], setup.validz_s[rank])
        rows = slice(rank * P, (rank + 1) * P)
        np.testing.assert_array_equal(r["bc_mask"], setup.bc_mask_pad[rows])
        np.testing.assert_array_equal(r["bc_vals"], setup.bc_vals_pad[rows])


@pytest.mark.parametrize("size", WORLDS)
def test_fine_block_and_preconditioner_match_jax(ranks, size):
    setup, vals, b, z = _jax_fine(size)
    P = setup.rows_per_shard
    for rank, r in enumerate(ranks[size]):
        rows = slice(rank * P, (rank + 1) * P)
        np.testing.assert_allclose(r["vals"], vals[:, rows], rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(r["b"], b[rows], rtol=0, atol=1e-12)
        np.testing.assert_allclose(r["z"], z, rtol=0, atol=1e-12)


@pytest.mark.parametrize("size", WORLDS)
def test_coarse_correction_has_the_same_bits_on_every_rank(ranks, size):
    ec = [r["ec"] for r in ranks[size]]
    assert np.isfinite(ec[0]).all() and np.abs(ec[0]).max() > 0
    for other in ec[1:]:
        np.testing.assert_array_equal(other, ec[0])


@functools.lru_cache(maxsize=None)
def _jax_solve(name, n):
    from pfemfort_tpu.elements.poisson import poisson_element_matrices as jp
    from pfemfort_tpu.mesh import generate as jgen
    from pfemfort_tpu.parallel.dist_mg import solve_sharded_mg

    import jax.numpy as jnp

    dims = SOLVES[name]
    mesh, dbc = jgen.box_tet(0, 1, dims[0], 0, 1, dims[1], 0, 1, dims[2])
    u, st, _ = solve_sharded_mg(mesh, 1, dbc, lambda c: _poisson(c, jp),
                                device_mesh=_device_mesh(n), rtol=1e-8,
                                maxiter=60, dtype=jnp.float64)
    return mesh, u, int(np.asarray(st.iters))


@pytest.mark.parametrize("size,name", [(2, "8x8x16"), (4, "8x8x16"),
                                       (8, "8x8x16"), (4, "6x6x10")])
def test_mg_solve_matches_jax(ranks, size, name):
    mesh, u, iters = _jax_solve(name, size)
    for r in ranks[size]:
        assert bool(r[f"mg {name}"])
        assert int(r[f"iters {name}"]) == iters
        np.testing.assert_allclose(r[f"u {name}"], u, rtol=0, atol=1e-10)
    u_exact = (mesh.coords ** 2).sum(axis=1)
    assert np.abs(ranks[size][0][f"u {name}"] - u_exact).max() < 5e-5


@pytest.mark.parametrize("size", WORLDS)
def test_chebyshev_coarse_tail(ranks, size):
    """A box_tet 30x30x34: its coarse lattice (15 x 15 x 17 cells, 4,608
    nodes) is odd and above the 4,096-row dense inverse, so the coarse tail
    is one level solved by the Chebyshev polynomial; the JAX test's bars
    (tests/test_dist_mg.py:test_dist_mg_chebyshev_coarse_tail)."""
    mesh, _ = generate.box_tet(0, 1, 30, 0, 1, 30, 0, 1, 34)
    u_exact = (mesh.coords ** 2).sum(axis=1)
    for r in ranks[size]:
        assert int(r["cheby levels"]) == 2 and bool(r["cheby converged"])
        assert np.abs(r["cheby u"] - u_exact).max() < 5e-5
        np.testing.assert_array_equal(r["cheby u"], ranks[size][0]["cheby u"])


@functools.lru_cache(maxsize=None)
def _jax_keywords(case, n=4):
    """JAX's solve_sharded_mg with its keywords, on n devices (4, as
    tests/test_dist_mg.py runs it; JAX's count and u do not move with the
    device count here, and each run costs ~35 s of compilation): 'tail' is
    tests/test_dist_mg.py's Chebyshev-tail case (12^3, coarsest_max_dof
    50) in float64; 'elastic' the elasticity box with nu = 1, omega =
    0.8.  Returns (mesh, u, iterations)."""
    import jax.numpy as jnp
    from pfemfort_tpu.elements import elasticity as jel
    from pfemfort_tpu.elements.poisson import poisson_element_matrices as jp
    from pfemfort_tpu.mesh import generate as jgen
    from pfemfort_tpu.parallel.dist_mg import solve_sharded_mg

    if case == "tail":
        mesh, dbc = jgen.box_tet(0, 1, 12, 0, 1, 12, 0, 1, 12)
        args = (mesh, 1, dbc, lambda c: _poisson(c, jp))
        kw = dict(rtol=1e-8, maxiter=60, coarsest_max_dof=50)
    else:
        mesh, dbc = _elastic_case(jgen)
        args = (mesh, 3, dbc,
                _elastic_fn(jel.dmat_3d, jel.elasticity_stiffness))
        kw = dict(rtol=1e-10, maxiter=200, nu=1, omega=0.8)
    u, st, _ = solve_sharded_mg(*args, device_mesh=_device_mesh(n),
                                dtype=jnp.float64, **kw)
    assert bool(np.asarray(st.converged))
    return mesh, np.asarray(u), int(np.asarray(st.iters))


@pytest.mark.parametrize("size", WORLDS)
def test_coarsest_max_dof_tail_matches_jax(ranks, size):
    """tests/test_dist_mg.py:test_dist_mg_chebyshev_coarse_tail through
    the port's `coarsest_max_dof`: the 4^3 coarse lattice (125 rows) is
    above the cap of 50, so the coarse tail ends in the Chebyshev solve;
    JAX's count, u within 1e-10 of JAX's, and JAX's nodal bar."""
    mesh, u, iters = _jax_keywords("tail")
    u_exact = (mesh.coords ** 2).sum(axis=1)
    for r in ranks[size]:
        assert bool(r["tail converged"])
        assert int(r["tail iters"]) == iters
        np.testing.assert_allclose(r["tail u"], u, rtol=0, atol=1e-10)
        assert np.abs(r["tail u"][:mesh.n_node] - u_exact).max() < 5e-5


@pytest.mark.parametrize("size", WORLDS)
def test_given_smoothing_on_elasticity_matches_jax(ranks, size):
    """nu = 1, omega = 0.8 passed to both packages' solve_sharded_mg on
    the elasticity box: used as given, JAX's count and u."""
    _, u, iters = _jax_keywords("elastic")
    for r in ranks[size]:
        assert tuple(r["el given smoothing"]) == (1, 0.8)
        assert int(r["el given iters"]) == iters
        np.testing.assert_allclose(r["el given u"], u, rtol=0, atol=1e-10)


@functools.lru_cache(maxsize=None)
def _jax_elastic():
    import jax.numpy as jnp
    from pfemfort_tpu.elements import elasticity as jel
    from pfemfort_tpu.mesh import generate as jgen
    from pfemfort_tpu.parallel.dist_mg import solve_sharded_mg

    mesh, dbc = _elastic_case(jgen)
    u, st, _ = solve_sharded_mg(
        mesh, 3, dbc, _elastic_fn(jel.dmat_3d, jel.elasticity_stiffness),
        device_mesh=_device_mesh(4), rtol=1e-10, maxiter=200,
        dtype=jnp.float64)
    assert bool(np.asarray(st.converged))
    return mesh, np.asarray(u)


@pytest.mark.parametrize("size", WORLDS)
def test_elasticity_mg_beats_jacobi_and_matches_jax(ranks, size):
    mesh, u = _jax_elastic()
    for r in ranks[size]:
        assert str(r["el used mg"]) == "mg"
        assert bool(r["el converged mg"]) and bool(r["el converged jacobi"])
        assert int(r["el iters mg"]) < int(r["el iters jacobi"])
        np.testing.assert_allclose(r["el u mg"], u, rtol=0, atol=1e-8)
        np.testing.assert_allclose(r["el u mg"],
                                   _linear_field(mesh.coords).reshape(-1),
                                   rtol=0, atol=1e-8)
        assert 0.0 < float(r["el omega mg"]) < 2.0


@functools.lru_cache(maxsize=None)
def _jax_refusals(n):
    from pfemfort_tpu.drivers.sharded import solve_implicit_sharded as j_solve
    from pfemfort_tpu.elements.poisson import poisson_element_matrices as jp
    from pfemfort_tpu.mesh import generate as jgen

    dm = _device_mesh(n)
    return {case: j_solve(m, 1, d, lambda c: _poisson(c, jp),
                          device_mesh=dm, force_bc=f, precond="mg", **kw)
            for case, (m, d, f, kw) in _refused_cases(jgen).items()}


@pytest.mark.parametrize("size", WORLDS)
def test_mg_refusals_fall_back_as_jax_does(ranks, size):
    ref = _jax_refusals(size)
    for case, res in ref.items():
        for r in ranks[size]:
            assert str(r[f"{case} refused"]) == res.timings["mg_refused"]
            assert str(r[f"{case} used"]) == res.timings["precond_used"]
            assert int(r[f"{case} iters"]) == int(np.asarray(res.stats.iters))
            np.testing.assert_allclose(r[f"{case} u"], res.u_full, rtol=0,
                                       atol=1e-10)


@pytest.fixture(scope="module")
def world1():
    multihost.initialize(device="cpu")
    yield
    multihost.shutdown()


def test_fine_weight_at_world_size_1_is_the_single_device_weight(world1):
    from pfemfort_tpu_torch.solve.multigrid import _jacobi_weight, build_gmg

    mesh, dbc = _elastic_case()
    efn = _elastic_fn()
    setup = dist_mg.build_dist_mg_setup(mesh, 3, dbc, efn, 1, 0, dtype=F64,
                                        nu=2, omega=None, device="cpu")
    as_t = lambda a: torch.as_tensor(a, dtype=F64)
    bc_l = torch.as_tensor(setup.bc_mask)
    vals_l, _ = dist_mg.assemble_fine_shard(
        setup, efn, as_t(setup.coords), as_t(setup.validz), bc_l,
        as_t(setup.bc_vals))
    w = dist_mg.fine_jacobi_weight(
        setup, dist_mg.fine_spmv_factory(setup, vals_l),
        vals_l[setup.offsets.index(0)])
    from pfemfort_tpu_torch.dofs.dofmap import build_dofmap

    bc_full = ~build_dofmap(mesh, 3, dbc).free_mask_full()
    arrays, _ = build_gmg(mesh, 3, bc_full, efn, dtype=F64, device="cpu")
    np.testing.assert_allclose(w, _jacobi_weight(arrays.mats[0]),
                               rtol=1e-12)


def test_preconditioner_on_the_jax_setup_matches_jax(world1):
    from pfemfort_tpu_torch.interop import dist_mg_setup_from_numpy

    jsetup, vals, b, z = _jax_fine(1)
    setup = dist_mg_setup_from_numpy(jsetup, 0, device="cpu", dtype=F64)
    as_t = lambda a: torch.as_tensor(a, dtype=F64)
    bc_l = torch.as_tensor(setup.bc_mask)
    vals_l, b_l = dist_mg.assemble_fine_shard(
        setup, _poisson, as_t(setup.coords), as_t(setup.validz), bc_l,
        as_t(setup.bc_vals))
    np.testing.assert_allclose(vals_l.numpy(), vals, rtol=0, atol=1e-12)
    np.testing.assert_allclose(b_l.numpy(), b, rtol=0, atol=1e-12)
    diag = vals_l[setup.offsets.index(0)]
    pc = dist_mg.dist_gmg_preconditioner(
        setup, torch.where(diag != 0, 1.0 / diag, 0.0),
        torch.where(bc_l, 0.0, 1.0).to(F64), setup.coarse[0],
        dist_mg.fine_spmv_factory(setup, vals_l))
    got = pc(as_t(_residual(setup.n_rows_padded))).numpy()
    np.testing.assert_allclose(got, z, rtol=0, atol=1e-12)


if __name__ == "__main__":      # one rank, as the `ranks` fixture starts it
    multihost.initialize(device="cpu")
    try:
        _ranks(sys.argv[1])
    finally:
        multihost.shutdown()
