"""Port parity: the per-rank hybrid of the distributed ELL route
(parallel/dist_ell.py: build_ell_halo_hybrid, spmv_ell_halo_hybrid;
shard_cg.distributed_cg_solve_ell(hybrid=); the float32 ELL route of
drivers/sharded.py).

In this process, without a process group:
  * the split against the JAX package's build_ell_halo_hybrid on the mesh
    of its own test (tests/test_dist_ell.py:325: box_tet 5x5x8, nodes
    permuted by default_rng(11), S = 4): the port's per-rank columns laid
    out on the host equal JAX's stacked cols_local, the offsets chosen
    from the summed census equal JAX's (also with max_d = 5, so that the
    stable argsort's tie order decides), and every rank's dia_src is bit
    for bit JAX's;
  * a census with no dense diagonal gives no offsets, and JAX returns None
    there too.
On 2, 4 and 8 gloo ranks (this file run as a script under torchrun, once
per world size; the rank processes never import JAX), float64 unless
said:
  * at 4 ranks, spmv_ell_halo_hybrid on that mesh with random values and
    x, rank by rank within 1e-12 of JAX's numpy reference of its own test
    (the DIA loop plus apply_slotgather_reference on the ghost-extended
    vector);
  * Jacobi-CG with `hybrid=` forced on the scrambled box (the JAX dry
    run's `dist/ell` mesh, rtol 1e-6) and on a scrambled Delaunay mesh
    whose remainder holds ghost columns (rtol 1e-10): JAX's iteration
    counts and u within 1e-10 of JAX's solve_implicit_sharded;
  * at 2 ranks: per-rank IC(0) on the scrambled box and the distributed
    SA-AMG on a jittered scrambled box (891 free rows, so it coarsens),
    each with the hybrid operator, against JAX; the float32 driver route
    on the jittered mesh (inshard_kernel 'hybrid', its counts reported,
    the count within 2% of the port's float64 count); and the route with
    no dense diagonal, which keeps B2 on the whole block.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pfemfort_tpu_torch.drivers import sharded as sharded_driver
from pfemfort_tpu_torch.drivers.sharded import \
    assemble_implicit_sharded_ell, solve_implicit_sharded
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
from pfemfort_tpu_torch.mesh import generate
from pfemfort_tpu_torch.mesh.core import Mesh
from pfemfort_tpu_torch.parallel import multihost
from pfemfort_tpu_torch.parallel.dist_ell import build_dist_ell_setup, \
    build_ell_halo, build_ell_halo_hybrid, hybrid_counts, hybrid_offsets, \
    hybrid_split, local_columns, reader_plan, spmv_ell_halo_hybrid
from pfemfort_tpu_torch.parallel.shard import build_sharded_system
from pfemfort_tpu_torch.parallel.shard_cg import distributed_cg_solve_ell
from pfemfort_tpu_torch.solve.ic0 import build_ic0_shard_block
from pfemfort_tpu_torch.sparse.hybrid import hybrid_layout

WORLDS = (2, 4, 8)
F64 = torch.float64
SPLIT_S = 4
SOLVES = {"box": dict(rtol=1e-6, maxiter=500),
          "delaunay": dict(rtol=1e-10)}


def _scramble(mesh, dbc, seed):
    perm = np.random.default_rng(seed).permutation(mesh.n_node)
    dbc = dbc.copy()
    dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    return mesh.renumbered(perm.astype(np.int64)), dbc


def _split_mesh(gen=generate):
    """tests/test_dist_ell.py:325's mesh."""
    return _scramble(*gen.box_tet(0, 1, 5, 0, 1, 5, 0, 1, 8), 11)


def _jittered(gen=generate, mesh_cls=Mesh):
    """box_tet 10x10x12 with its interior nodes moved by up to 0.01 and
    its nodes permuted (tests/test_torch_dist_cli.py's SA-AMG mesh)."""
    mesh, dbc = gen.box_tet(0, 1, 10, 0, 1, 10, 0, 1.2, 12)
    rng = np.random.default_rng(4)
    X = mesh.coords.copy()
    inside = ((X > 1e-9) & (X < X.max(axis=0) - 1e-9)).all(axis=1)
    X[inside] += rng.uniform(-0.01, 0.01, (int(inside.sum()), 3))
    return _scramble(mesh_cls(mesh.etype, X, mesh.conn), dbc, 5)


def _delaunay(mesh_cls=Mesh):
    """tests/test_dist_ell.py's scrambled Delaunay mesh of the unit cube,
    u = x^2+y^2+z^2 on the hull."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(1)
    n = 6
    g = np.linspace(0, 1, n + 1)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    pts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    interior = ((pts > 1e-9) & (pts < 1 - 1e-9)).all(axis=1)
    pts[interior] += rng.uniform(-0.25, 0.25, (int(interior.sum()), 3)) / n
    tri = Delaunay(pts)
    conn = tri.simplices.astype(np.int64)
    a, b, c, d = (pts[conn[:, i]] for i in range(4))
    vol6 = np.einsum("ij,ij->i", np.cross(b - a, c - a), d - a)
    neg = vol6 < 0
    conn[neg] = conn[neg][:, [0, 2, 1, 3]]
    conn = conn[np.abs(vol6) > 1e-12]
    perm = rng.permutation(len(pts))
    inv = np.empty(len(pts), np.int64)
    inv[perm] = np.arange(len(pts))
    pts = pts[perm]
    conn = inv[conn]
    hull = np.unique(inv[np.unique(tri.convex_hull)])
    u_ex = (pts ** 2).sum(axis=1)
    dbc = np.stack([hull, np.zeros(len(hull)), u_ex[hull]], axis=1)
    return mesh_cls("tetra4", pts, conn.astype(np.int32)), dbc


def _meshes(gen=generate, mesh_cls=Mesh):
    return {"box": _scramble(*gen.box_tet(0, 1, 5, 0, 1, 5, 0, 1, 8), 0),
            "delaunay": _delaunay(mesh_cls),
            "jittered": _jittered(gen, mesh_cls)}


def _poisson(c):
    return poisson_element_matrices(c, "tetra4", source=-6.0)


def _host_cols_local(mesh, dbc, S):
    """Every rank's (P, K) ghost-extended columns, laid out on the host
    without a process group, and Wx."""
    sys_ = build_sharded_system(mesh, 1, dbc, S, method="rcb", layout="ell")
    P, n_rows = sys_.rows_per_shard, sys_.n_rows_padded
    cols = torch.as_tensor(sys_.pattern.ell_cols)
    blocks = [cols[t * P:(t + 1) * P] for t in range(S)]
    plans = [reader_plan(c, t, S, n_rows) for t, c in enumerate(blocks)]
    wx = 8 * -(-max(max(int(p.counts.max()) for p in plans), 1) // 8)
    return np.stack([local_columns(c, plans[t], t, S, n_rows, wx).numpy()
                     for t, c in enumerate(blocks)]), wx


# ---------------------------------------------------------------------------
# the rank processes
# ---------------------------------------------------------------------------

def _forced(mesh, dbc, dtype=F64, precond="jacobi", **kw):
    """The ELL route's steps with the hybrid forced whatever the dtype:
    set-up, census and split, assembly, packing, the Krylov solve with
    `hybrid=`.  Returns (u_full, iterations, the rank's plan)."""
    rank, size = multihost.world().rank, multihost.world().size
    setup = build_dist_ell_setup(mesh, 1, dbc, size, rank, device="cpu")
    halo = build_ell_halo(setup.sys, rank, device="cpu")
    plan = build_ell_halo_hybrid(halo)
    vals, b = assemble_implicit_sharded_ell(setup, _poisson, dtype, "cpu")
    H = hybrid_layout(plan, "cpu").pack(vals)
    ic0 = amg = None
    if precond == "ic0":
        ic0 = build_ic0_shard_block(halo.cols_local.numpy(),
                                    vals.to(F64).numpy(), dtype=dtype,
                                    device="cpu")
    if precond == "amg":
        amg, _ = sharded_driver._dist_samg(setup.sys, mesh, 1, vals, dtype,
                                           "cpu")
        assert amg is not None
    x, st = distributed_cg_solve_ell(halo.cols_local, vals, b, halo,
                                     ic0=ic0, amg=amg, hybrid=H, **kw)
    sys_ = setup.sys
    u = sys_.dofmap.expand_solution(sys_.reduce_solution(
        x.to(F64).numpy()))
    return u, int(st.iters), plan


def _ranks(outdir):
    import torch.distributed as dist

    assert "jax" not in sys.modules
    rank, size = dist.get_rank(), dist.get_world_size()
    out = {}
    meshes = _meshes()
    for name, kw in SOLVES.items():
        u, it, plan = _forced(*meshes[name], **kw)
        out[f"{name}_u"], out[f"{name}_iters"] = u, it
        out[f"{name}_offsets"] = np.asarray(plan.offsets)
        ghosts = 0 if plan.rem_cols is None else int(
            ((plan.rem_cols >= plan.n_rows)
             & (plan.rem_cols < plan.rem_n_cols)).sum())
        out[f"{name}_rem_ghost_slots"] = ghosts

    if size == SPLIT_S:
        mesh, dbc = _split_mesh()
        setup = build_dist_ell_setup(mesh, 1, dbc, size, rank, device="cpu")
        halo = build_ell_halo(setup.sys, rank, device="cpu")
        plan = build_ell_halo_hybrid(halo)
        P, K = halo.cols_local.shape
        rng = np.random.default_rng(0)
        vals = rng.standard_normal((size, P, K))
        x = rng.standard_normal((size, P))
        H = hybrid_layout(plan, "cpu").pack(torch.as_tensor(vals[rank]))
        out["product"] = spmv_ell_halo_hybrid(
            H, halo, torch.as_tensor(x[rank])).numpy()
        out["product_has_rem"] = H.rem is not None

    if size == 2:
        box, jit = meshes["box"], meshes["jittered"]
        out["ic0_u"], out["ic0_iters"], _ = _forced(
            *box, precond="ic0", rtol=1e-6, maxiter=500)
        out["amg_u"], out["amg_iters"], _ = _forced(
            *jit, precond="amg", rtol=1e-8)
        for dtype in (torch.float32, F64):
            res = solve_implicit_sharded(jit[0], 1, jit[1], _poisson,
                                         dtype=dtype,
                                         rtol=1e-6, recover=False,
                                         device="cpu")
            tag = str(dtype)[6:]
            out[f"route_{tag}_iters"] = res.stats.iters
            out[f"route_{tag}_u"] = res.u_full
            for k, v in res.timings.items():
                if k.startswith("hybrid_") or k == "inshard_kernel":
                    out[f"route_{tag}_{k}"] = v
        # no dense diagonal: a threshold no diagonal reaches
        sharded_driver.build_ell_halo_hybrid = functools.partial(
            build_ell_halo_hybrid, fill_threshold=2.0)
        try:
            res = solve_implicit_sharded(jit[0], 1, jit[1], _poisson,
                                         dtype=torch.float32, rtol=1e-6,
                                         recover=False, device="cpu")
        finally:
            sharded_driver.build_ell_halo_hybrid = build_ell_halo_hybrid
        out["nodense_kernel"] = res.timings["inshard_kernel"]
        out["nodense_hybrid_keys"] = sorted(
            k for k in res.timings if k.startswith("hybrid_"))
        out["nodense_iters"], out["nodense_u"] = res.stats.iters, res.u_full
    np.savez(Path(outdir) / f"rank{rank}.npz", **out)
    assert "jax" not in sys.modules


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = {}
    for size in WORLDS:
        d = tmp_path_factory.mktemp(f"world{size}")
        rc = multihost.torchrun_ranks([__file__, str(d)], size, timeout=300)
        assert rc == 0
        out[size] = [dict(np.load(d / f"rank{r}.npz", allow_pickle=True))
                     for r in range(size)]
    return out


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_split():
    from pfemfort_tpu.mesh import generate as jgen
    from pfemfort_tpu.parallel.dist_ell import build_dist_ell_setup as j_setup
    from pfemfort_tpu.parallel.dist_ell import build_ell_halo as j_halo

    mesh, dbc = _split_mesh(jgen)
    setup = j_setup(mesh, 1, dbc, SPLIT_S)
    cols_local, send_rows, wx = j_halo(setup)
    return dict(cols_local=cols_local, send_rows=send_rows, wx=wx,
                P=setup.sys.rows_per_shard, K=setup.ell_k)


@pytest.fixture(scope="module")
def jax_solve():
    import jax
    from pfemfort_tpu.drivers.sharded import solve_implicit_sharded as j_solve
    from pfemfort_tpu.elements import poisson as jpo
    from pfemfort_tpu.mesh import generate as jgen
    from pfemfort_tpu.mesh.core import Mesh as JMesh

    meshes = _meshes(jgen, JMesh)
    fn = lambda c: jpo.poisson_element_matrices(c, "tetra4", source=-6.0)
    memo = {}

    def get(size, name, **kw):
        key = (size, name, tuple(sorted(kw.items())))
        if key not in memo:
            dm = jax.sharding.Mesh(np.array(jax.devices()[:size]), ("shard",))
            mesh, dbc = meshes[name]
            ref = j_solve(mesh, 1, dbc, fn, device_mesh=dm, recover=False,
                          **kw)
            assert ref.timings["assembly_layout"] == "ell"
            assert bool(np.asarray(ref.stats.converged))
            memo[key] = ref
        return memo[key]
    return get


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_d", [48, 5])
def test_split_equals_jax(jax_split, max_d):
    from pfemfort_tpu.parallel.dist_ell import build_ell_halo_hybrid as j_hy

    cols, wx = _host_cols_local(*_split_mesh(), SPLIT_S)
    np.testing.assert_array_equal(cols, jax_split["cols_local"])
    assert wx == jax_split["wx"]
    P = jax_split["P"]
    ref = j_hy(jax_split["cols_local"], wx, P, max_d=max_d)
    assert ref is not None
    census = sum(hybrid_counts(c) for c in cols)
    offsets = hybrid_offsets(census, SPLIT_S, max_d=max_d)
    assert offsets == ref["offsets"]
    assert len(offsets) == min(max_d, len(ref["offsets"]))
    for s in range(SPLIT_S):
        plan = hybrid_split(cols[s], offsets, P + SPLIT_S * wx)
        np.testing.assert_array_equal(plan.dia_src,
                                      ref["dia_src"][s].astype(np.int64))
        # every live slot lands in exactly one part
        live = int((cols[s] < P + SPLIT_S * wx).sum())
        assert plan.nnz_dia + plan.nnz_rem == live


def test_no_dense_diagonal_gives_no_split(jax_split):
    from pfemfort_tpu.parallel.dist_ell import build_ell_halo_hybrid as j_hy

    cols, wx = jax_split["cols_local"], jax_split["wx"]
    P = jax_split["P"]
    assert j_hy(cols, wx, P, fill_threshold=2.0) is None
    census = sum(hybrid_counts(c) for c in cols)
    assert hybrid_offsets(census, SPLIT_S, fill_threshold=2.0) == ()
    ghosts_only = np.where(cols[1] < P, P + SPLIT_S * wx, cols[1])
    assert not hybrid_counts(ghosts_only).any()
    assert hybrid_offsets(hybrid_counts(ghosts_only), 1) == ()


def test_hybrid_product_equals_jax_reference(ranks, jax_split):
    """Each rank's spmv_ell_halo_hybrid against the JAX test's numpy
    reference: the DIA part on the rank's own x, JAX's slot-gather plan of
    the remainder on the ghost-extended vector."""
    from pfemfort_tpu.parallel.dist_ell import build_ell_halo_hybrid as j_hy
    from pfemfort_tpu.sparse.slotgather import SlotGatherPlan, \
        apply_slotgather_reference

    S, P, K = SPLIT_S, jax_split["P"], jax_split["K"]
    wx, send_rows = jax_split["wx"], jax_split["send_rows"]
    hy = j_hy(jax_split["cols_local"], wx, P)
    T, V, G, _, nce = hy["dims"]
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((S, P, K))
    x = rng.standard_normal((S, P))
    assert any(bool(r["product_has_rem"]) for r in ranks[S])
    for s, res in enumerate(ranks[S]):
        xg = np.zeros(nce)
        xg[:P] = x[s]
        for o in range(S):
            xg[P + o * wx:P + (o + 1) * wx] = x[o][send_rows[o, s]]
        y = np.zeros(P)
        for d, off in enumerate(hy["offsets"]):
            src = hy["dia_src"][s, d].astype(np.int64)
            rr = np.nonzero(src >= 0)[0]
            y[rr] += vals[s].reshape(-1)[src[rr]] * x[s][rr + off]
        plan = SlotGatherPlan(
            n_rows=P, T=T, V=V, G=G, qsel=hy["qsel"][s],
            vstart=hy["vstart"][s], rsel=hy["rsel"][s], eps=hy["eps"][s],
            src=hy["src"][s].astype(np.int64), n_cols=nce)
        valsv = np.where(plan.src >= 0,
                         vals[s].reshape(-1)[np.clip(plan.src, 0, None)],
                         0.0)
        y = y + apply_slotgather_reference(plan, valsv, xg)
        err = np.abs(res["product"] - y).max() / np.abs(y).max()
        assert err <= 1e-12, (s, err)


@pytest.mark.parametrize("name", tuple(SOLVES))
@pytest.mark.parametrize("size", WORLDS)
def test_forced_hybrid_solve_matches_jax(ranks, jax_solve, size, name):
    ref = jax_solve(size, name, **SOLVES[name])
    for r in ranks[size]:
        assert int(r[f"{name}_iters"]) == int(np.asarray(ref.stats.iters))
        np.testing.assert_allclose(r[f"{name}_u"], ref.u_full, rtol=0,
                                   atol=1e-10)
        assert len(r[f"{name}_offsets"]) > 0
        np.testing.assert_array_equal(r[f"{name}_offsets"],
                                      ranks[size][0][f"{name}_offsets"])
    if name == "delaunay":      # the remainder reads ghost columns
        assert all(int(r["delaunay_rem_ghost_slots"]) > 0
                   for r in ranks[size])


@pytest.mark.parametrize("precond", ["ic0", "amg"])
def test_preconditioners_with_the_hybrid_operator_match_jax(ranks, jax_solve,
                                                            precond):
    name, kw = ("box", dict(rtol=1e-6, maxiter=500)) if precond == "ic0" \
        else ("jittered", dict(rtol=1e-8))
    ref = jax_solve(2, name, precond=precond, **kw)
    assert ref.timings["precond_used"] == precond
    for r in ranks[2]:
        assert int(r[f"{precond}_iters"]) == int(np.asarray(ref.stats.iters))
        np.testing.assert_allclose(r[f"{precond}_u"], ref.u_full, rtol=0,
                                   atol=1e-10)


def test_float32_route_takes_the_hybrid(ranks):
    for r in ranks[2]:
        assert str(r["route_float32_inshard_kernel"]) == "hybrid"
        assert str(r["route_float64_inshard_kernel"]) == "spmv_sliced"
        assert int(r["route_float32_hybrid_diagonals"]) > 0
        assert int(r["route_float32_hybrid_nnz_dia"]) > 0
        assert "route_float64_hybrid_diagonals" not in r
        it32, it64 = int(r["route_float32_iters"]), int(r["route_float64_iters"])
        assert abs(it32 - it64) <= 0.02 * it64
        assert np.abs(r["route_float32_u"] - r["route_float64_u"]).max() \
            <= 1e-4


def test_no_dense_diagonal_keeps_b2(ranks):
    for r in ranks[2]:
        assert str(r["nodense_kernel"]) == "spmv_sliced"
        assert len(r["nodense_hybrid_keys"]) == 0
        it = int(r["route_float32_iters"])
        assert abs(int(r["nodense_iters"]) - it) <= 0.02 * it
        assert np.abs(r["nodense_u"] - r["route_float32_u"]).max() <= 1e-4


if __name__ == "__main__":      # one rank, as the `ranks` fixture starts it
    multihost.initialize(device="cpu")
    try:
        _ranks(sys.argv[1])
    finally:
        multihost.shutdown()
