"""Port parity: the distributed set-up and the halo exchange.

`build_sharded_system` (slab, rcb, greedy; ndof 1 and 3) and
`build_dist_setup` are host numpy: every array must equal the JAX
package's (per rank: `build_dist_setup` builds one rank's block) bit for
bit.  `exchange_halos` and the plain `spmv_dia_halo` run on 2 and 4 gloo
ranks, each rank a process (this file run as a script under torchrun) that
never imports JAX; the JAX side runs in this process under shard_map on
the virtual CPU devices; float64, to 1e-12.  On the JAX package's lattice
case the plain form equals its lattice stencil form too.  Also the
bootstrap (parallel/multihost.py) at world size 1 and its errors, and B1's
halo wrapper on CPU tensors (its plain version).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pfemfort_tpu_torch.mesh import generate
from pfemfort_tpu_torch.parallel import multihost
from pfemfort_tpu_torch.parallel.dist_assembly import build_dist_setup
from pfemfort_tpu_torch.parallel.halo import exchange_halos, halo_width, \
    spmv_dia_halo
from pfemfort_tpu_torch.parallel.shard import build_sharded_system
from pfemfort_tpu_torch.sparse.dia import DIAMatrix, spmv_dia_halo_local
from pfemfort_tpu_torch.sparse.dia_spmv_cuda import dia_spmv_halo

WORLDS = (2, 4)
PATTERN_FIELDS = ("layout", "n_rows", "rhs_dest", "dia_offsets",
                  "dia_lattice", "elem_dof_t", "nnz", "indptr", "indices",
                  "ell_k", "ell_cols", "mat_perm", "mat_segids", "mat_nsegs")


def _box(nx, ny, nz, gen=generate):
    return gen.box_tet(0, 1, nx, 0, 1, ny, 0, 1, nz)


def _clamped_box(nx, ny, nz, gen=generate):
    """3D elasticity: base z=0 clamped in every component."""
    mesh, _ = _box(nx, ny, nz, gen)
    base = np.nonzero(np.isclose(mesh.coords[:, 2], 0))[0]
    dbc = np.array([[n, d, 0.0] for n in base for d in (0, 1, 2)])
    return mesh, dbc


def _halo_case(gen=generate):
    """The box whose slab-sharded DIA offsets the halo cases use, with
    random values (_random_system), the same in both packages."""
    return gen.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 8)


def _random_system(n_rows, n_diag):
    rng = np.random.default_rng(1)
    return (rng.standard_normal((n_diag, n_rows)),
            rng.standard_normal(n_rows))


def _lattice_case(gen=generate):
    return gen.box_tet(0, 1, 6, 0, 1, 7, 0, 1, 9)


# ---- rank side: runs in the processes torchrun starts (see the end) -----

def _ranks(outdir):
    import torch.distributed as dist

    assert "jax" not in sys.modules
    rank, size = dist.get_rank(), dist.get_world_size()
    out = {}
    mesh, dbc = _halo_case()
    sys_ = build_sharded_system(mesh, 1, dbc, size, method="slab")
    offs = sys_.pattern.dia_offsets
    w = halo_width(offs)
    P = sys_.rows_per_shard
    vals, x = _random_system(sys_.n_rows_padded, len(offs))
    sl = slice(rank * P, (rank + 1) * P)
    x_l = torch.as_tensor(x[sl])
    left, right = exchange_halos(x_l, w)
    zero = np.zeros(w)
    out["left"] = zero if left is None else left.numpy()
    out["right"] = zero if right is None else right.numpy()
    out["left_none"] = left is None
    out["right_none"] = right is None
    out["y"] = spmv_dia_halo(offs, torch.as_tensor(vals[:, sl]), x_l,
                             w).numpy()
    if size == 4:
        from pfemfort_tpu_torch.assembly.assemble import assemble_matrix, \
            build_assembly_plan
        from pfemfort_tpu_torch.elements.geometry import to_element_minor
        from pfemfort_tpu_torch.elements.poisson import \
            poisson_element_matrices

        mesh, dbc = _lattice_case()
        sys_ = build_sharded_system(mesh, 1, dbc, 4, method="slab")
        offs = sys_.pattern.dia_offsets
        Ke, _ = poisson_element_matrices(
            torch.as_tensor(to_element_minor(mesh.elem_coords())), "tetra4",
            source=-6.0)
        A = assemble_matrix(Ke, build_assembly_plan(sys_.pattern, "cpu"))
        xl = np.random.default_rng(0).normal(size=sys_.n_rows_padded)
        P = sys_.rows_per_shard
        sl = slice(rank * P, (rank + 1) * P)
        out["y_lattice"] = spmv_dia_halo(offs, A.vals[:, sl],
                                         torch.as_tensor(xl[sl]),
                                         halo_width(offs)).numpy()
    np.savez(Path(outdir) / f"rank{rank}.npz", **out)
    assert "jax" not in sys.modules


# ---- test side -----------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every world size launched once: {world: [rank results]}."""
    out = {}
    for size in WORLDS:
        d = tmp_path_factory.mktemp(f"world{size}")
        rc = multihost.torchrun_ranks([__file__, str(d)], size,
                                         timeout=300)
        assert rc == 0
        out[size] = [dict(np.load(d / f"rank{r}.npz"))
                     for r in range(size)]
    return out


def _device_mesh(n):
    import jax

    return jax.sharding.Mesh(np.array(jax.devices()[:n]), ("shard",))


def _jax_sharded(fn, n, in_specs, out_specs, *args):
    import jax

    return jax.jit(jax.shard_map(fn, mesh=_device_mesh(n), in_specs=in_specs,
                                 out_specs=out_specs))(*args)


def _jgen():
    from pfemfort_tpu.mesh import generate as jgen

    return jgen


def _assert_same(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                            b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, (what, a, b)


@pytest.mark.parametrize("ndof", [1, 3])
@pytest.mark.parametrize("method", ["slab", "rcb", "greedy"])
def test_build_sharded_system_matches_jax(method, ndof):
    from pfemfort_tpu.parallel.shard import build_sharded_system as j_build

    case = (lambda g: _box(4, 4, 8, g)) if ndof == 1 \
        else (lambda g: _clamped_box(3, 3, 6, g))
    mesh, dbc = case(generate)
    t = build_sharded_system(mesh, ndof, dbc, 4, method=method)
    j = j_build(*case(_jgen())[:1], ndof, dbc, 4, method=method)
    for f in ("n_shards", "rows_per_shard", "n_rows_padded", "eq_perm",
              "elem_part", "node_part"):
        _assert_same(getattr(t, f), getattr(j, f), f)
    for f in PATTERN_FIELDS:
        _assert_same(getattr(t.pattern, f), getattr(j.pattern, f), f)
    for f in ("elem_dof", "assy_for_soln", "bc_values_full", "node_dof"):
        _assert_same(getattr(t.dofmap, f), getattr(j.dofmap, f), f)


@pytest.mark.parametrize("case", ["poisson 2", "poisson 4", "poisson 8",
                                  "elasticity 4"])
def test_build_dist_setup_matches_jax(case):
    from pfemfort_tpu.parallel.dist_assembly import \
        build_dist_setup as j_build

    kind, n = case.split()
    n = int(n)
    case = (lambda g: _box(4, 4, 4 * n, g)) if kind == "poisson" \
        else (lambda g: _clamped_box(3, 3, 16, g))
    mesh, dbc = case(generate)
    ndof = 1 if kind == "poisson" else 3
    j = j_build(case(_jgen())[0], ndof, dbc, n)
    for r in range(n):
        t = build_dist_setup(mesh, ndof, dbc, n, r)
        for f in ("offsets", "w", "emax", "elem_owner", "n_shards",
                  "rows_per_shard"):
            _assert_same(getattr(t, f), getattr(j, f), f)
        for f in ("coords", "edt", "ubc"):
            _assert_same(getattr(t, f), getattr(j, f + "_s")[r], f)
        _assert_same(t.sys.eq_perm, j.sys.eq_perm, "eq_perm")


@pytest.mark.parametrize("size", WORLDS)
def test_exchange_and_spmv_dia_halo_match_jax(ranks, size):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from pfemfort_tpu.parallel import halo as jhalo
    from pfemfort_tpu.parallel.shard import build_sharded_system as j_build

    mesh, dbc = _halo_case(_jgen())
    js = j_build(mesh, 1, dbc, size, method="slab")
    offs = js.pattern.dia_offsets
    w = jhalo.halo_width(offs)
    vals, x = _random_system(js.n_rows_padded, len(offs))
    left, right = _jax_sharded(
        lambda x_l: jhalo.exchange_halos(x_l, w, "shard"), size, P("shard"),
        (P("shard"), P("shard")), jnp.asarray(x))
    y = _jax_sharded(
        lambda v, x_l: jhalo.spmv_dia_halo(offs, v, x_l, w, "shard"), size,
        (P(None, "shard"), P("shard")), P("shard"), jnp.asarray(vals),
        jnp.asarray(x))
    res = ranks[size]
    np.testing.assert_array_equal(
        np.concatenate([r["left"] for r in res]), np.asarray(left))
    np.testing.assert_array_equal(
        np.concatenate([r["right"] for r in res]), np.asarray(right))
    # an edge rank has no neighbour on that side, and nothing is posted
    assert res[0]["left_none"] and res[-1]["right_none"]
    assert not any(r["left_none"] for r in res[1:])
    np.testing.assert_allclose(np.concatenate([r["y"] for r in res]),
                               np.asarray(y), rtol=0, atol=1e-12)


def test_halo_spmv_matches_jax_lattice_form(ranks):
    """The plain 1-D form on 4 ranks, on the JAX package's lattice case:
    equal to the JAX package's sharded lattice stencil and to its
    single-device DIA product."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from pfemfort_tpu.assembly.assemble import assemble_matrix
    from pfemfort_tpu.elements.geometry import to_element_minor
    from pfemfort_tpu.elements.poisson import poisson_element_matrices
    from pfemfort_tpu.parallel import halo as jhalo
    from pfemfort_tpu.parallel.shard import build_sharded_system as j_build
    from pfemfort_tpu.sparse.dia import spmv_dia

    mesh, dbc = _lattice_case(_jgen())
    js = j_build(mesh, 1, dbc, 4, method="slab")
    lat = js.pattern.dia_lattice
    shifts, wp = jhalo.lattice_halo_plan(js.pattern.dia_offsets, lat)
    Ke, _ = poisson_element_matrices(
        jnp.asarray(to_element_minor(mesh.elem_coords())), "tetra4",
        source=-6.0)
    A = assemble_matrix(Ke, js.pattern)
    x = jnp.asarray(np.random.default_rng(0).normal(size=js.n_rows_padded))
    y_j = _jax_sharded(
        lambda v, x_l: jhalo.spmv_dia_halo_lattice(shifts, v, x_l, lat, wp,
                                                   "shard"),
        4, (P(None, "shard"), P("shard")), P("shard"), A.vals, x)
    y_t = np.concatenate([r["y_lattice"] for r in ranks[4]])
    np.testing.assert_allclose(y_t, np.asarray(y_j), rtol=0, atol=1e-12)
    np.testing.assert_allclose(y_t, np.asarray(spmv_dia(A, x)), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("halos", ["both", "none", "left only"])
def test_b1_halo_wrapper_on_cpu_is_its_plain_version(halos):
    """dia_spmv_halo on CPU tensors takes spmv_dia_halo_local: y of the
    extended vector [left | x | right], None halos reading zeros."""
    rng = np.random.default_rng(3)
    P, offs = 40, (-11, -3, 0, 2, 11)
    w = halo_width(offs)
    A = DIAMatrix(vals=torch.as_tensor(rng.standard_normal((5, P))),
                  offsets=offs, n_rows=P)
    x = torch.as_tensor(rng.standard_normal(P))
    left = torch.as_tensor(rng.standard_normal(w))
    right = torch.as_tensor(rng.standard_normal(w))
    if halos == "none":
        left = right = None
    elif halos == "left only":
        right = None
    ext = np.concatenate([np.zeros(w) if left is None else left.numpy(),
                          x.numpy(),
                          np.zeros(w) if right is None else right.numpy()])
    dense = np.zeros((P, P + 2 * w))
    for d, o in enumerate(offs):
        dense[np.arange(P), w + np.arange(P) + o] = A.vals[d].numpy()
    y = dia_spmv_halo(A, x, left, right, torch.tensor(offs,
                                                      dtype=torch.int32))
    np.testing.assert_allclose(y.numpy(), dense @ ext, rtol=0, atol=1e-12)
    assert torch.equal(y, spmv_dia_halo_local(A, x, left, right))
    with pytest.raises(ValueError, match="largest"):
        spmv_dia_halo_local(A, x, torch.zeros(4, dtype=x.dtype), None)


def test_multihost_one_rank_group_and_errors():
    """initialize() without torchrun's environment makes a one-rank gloo
    group on a FileStore; NCCL ranks on a host with fewer cards raise."""
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="initialize"):
        multihost.world()
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match="found 0"):
            multihost.initialize(device="cuda")
    assert not dist.is_initialized()
    multihost.initialize(device="cpu")
    try:
        w = multihost.world()
        assert (w.rank, w.size, w.device.type) == (0, 1, "cpu")
        assert multihost.is_coordinator()
        # world size 1: nothing is posted, both halos are missing
        assert exchange_halos(torch.arange(16.0), 8) == (None, None)
        store = multihost._State.store_dir
        assert store is not None and Path(store).is_dir()
    finally:
        multihost.shutdown()
    assert not dist.is_initialized() and not Path(store).exists()


if __name__ == "__main__":      # one rank, as the `ranks` fixture starts it
    multihost.initialize(device="cpu")
    try:
        _ranks(sys.argv[1])
    finally:
        multihost.shutdown()
