"""Port parity: the distributed ELL route's set-up, assembly, ghost-exchange
SpMV and per-rank IC(0) blocks (parallel/dist_ell.py, solve/ic0.py) on 2,
4 and 8 gloo ranks.

Each world size is launched once (this file run as a script under
torchrun; the rank processes never import JAX).  Every rank builds its own
block of two scrambled systems, a Poisson box (the JAX package's
multichip dry-run `dist/ell` mesh: box_tet 5x5x8, nodes permuted by
default_rng(0)) and a 3D elasticity box with point loads, and writes its
arrays to `.npz`; the pytest process builds the JAX package's stacked
per-shard arrays of the same systems and runs its shard_map assembly and
halo SpMV.  float64 throughout:
  * set-up: perm, segids, recv_mat_dest, recv_rhs_dest, coordinates, BC
    values, w_mat, w_rhs, emax and the element owners equal JAX's shard
    arrays bit for bit; so do the reader plan (cols_local, send_rows, Wx),
    built with a process group, and the same plan built on the host
    without one;
  * assembly: each rank's (P, K) values and (P,) rhs within 1e-12 of JAX's
    block, and a second assembly equal bit for bit;
  * halo SpMV: spmv_ell_halo within 1e-12 of JAX's spmv_ell_halo;
  * IC(0) blocks: T, T^T and 1/diag within 1e-12 of JAX's
    build_ic0_shard_blocks (the port's per-rank width padded to JAX's
    stacked one).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pfemfort_tpu_torch.drivers.sharded import assemble_implicit_sharded_ell
from pfemfort_tpu_torch.elements.elasticity import dmat_3d, \
    elasticity_stiffness
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
from pfemfort_tpu_torch.mesh import generate
from pfemfort_tpu_torch.parallel import multihost
from pfemfort_tpu_torch.parallel.dist_ell import build_dist_ell_setup, \
    build_ell_halo, local_columns, reader_plan, spmv_ell_halo
from pfemfort_tpu_torch.solve.ic0 import build_ic0_shard_block
from pfemfort_tpu_torch.sparse.sliced import slice_ell

WORLDS = (2, 4, 8)
E, NU = 240.565, 0.3
SETUP_KEYS = ("perm", "segids", "recv_mat_dest", "recv_rhs_dest", "coords",
              "ubc")


def _scramble(mesh, tables, seed):
    perm = np.random.default_rng(seed).permutation(mesh.n_node)
    out = [mesh.renumbered(perm.astype(np.int64))]
    for t in tables:
        if t is not None:
            t = t.copy()
            t[:, 0] = perm[t[:, 0].astype(np.int64)]
        out.append(t)
    return out


def _cases(gen=generate):
    """name -> (mesh, ndof, dbc, fbc, element kind)."""
    mesh, dbc = gen.box_tet(0, 1, 5, 0, 1, 5, 0, 1, 8)
    mesh, dbc = _scramble(mesh, [dbc], 0)
    el, _ = gen.box_tet(0, 1, 3, 0, 1, 3, 0, 1, 6)
    base = np.nonzero(np.isclose(el.coords[:, 2], 0))[0]
    el_dbc = np.array([[n, d, 0.0] for n in base for d in (0, 1, 2)])
    tip = int(np.argmax(el.coords[:, 2]))
    fbc = np.array([[tip, 0, 1.0], [tip, 2, -0.5]])
    el, el_dbc, fbc = _scramble(el, [el_dbc, fbc], 1)
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


def _x(n_rows):
    return np.random.default_rng(7).standard_normal(n_rows)


def _ranks(outdir):
    import torch.distributed as dist

    assert "jax" not in sys.modules
    rank, size = dist.get_rank(), dist.get_world_size()
    out = {}
    for name, (mesh, ndof, dbc, fbc, kind) in _cases().items():
        setup = build_dist_ell_setup(mesh, ndof, dbc, size, rank,
                                     device="cpu")
        for key in SETUP_KEYS:
            v = getattr(setup, key)
            out[f"{name}_{key}"] = v.numpy() if torch.is_tensor(v) else v
        for key in ("w_mat", "w_rhs", "emax", "elem_owner"):
            out[f"{name}_{key}"] = getattr(setup, key)
        halo = build_ell_halo(setup.sys, rank, device="cpu")
        out[f"{name}_cols_local"] = halo.cols_local.numpy()
        send_rows = np.zeros((size, halo.wx), dtype=np.int64)
        for t, rows in halo.sends:          # JAX's send_rows[rank]
            send_rows[t, :len(rows)] = rows.numpy()
        out[f"{name}_send_rows"] = send_rows
        out[f"{name}_wx"] = halo.wx
        # the same reader plan on the host, without the group
        P, n_rows = setup.rows_per_shard, setup.sys.n_rows_padded
        cols = torch.as_tensor(setup.sys.pattern.ell_cols[rank * P:
                                                          (rank + 1) * P])
        out[f"{name}_host_cols_local"] = local_columns(
            cols, reader_plan(cols, rank, size, n_rows), rank, size, n_rows,
            halo.wx).numpy()

        fn = _element_fn(kind, _Torch)
        (v1, b1), (v2, b2) = (assemble_implicit_sharded_ell(
            setup, fn, torch.float64, "cpu", fbc) for _ in range(2))
        out[f"{name}_vals"], out[f"{name}_b"] = v1.numpy(), b1.numpy()
        out[f"{name}_repeat"] = torch.equal(v1, v2) and torch.equal(b1, b2)
        A = slice_ell(halo.cols_local, halo.n_cols).pack(v1)
        x_l = torch.as_tensor(_x(setup.sys.n_rows_padded)[rank * P:
                                                          (rank + 1) * P])
        out[f"{name}_y"] = spmv_ell_halo(A, halo, x_l).numpy()
        ic = build_ic0_shard_block(halo.cols_local.numpy(), v1.numpy(),
                                   dtype=torch.float64, device="cpu")
        for key, t in (("t_cols", ic.t.cols), ("t_vals", ic.t.vals),
                       ("tt_cols", ic.tt.cols), ("tt_vals", ic.tt.vals),
                       ("dinv", ic.dinv)):
            out[f"{name}_ic0_{key}"] = t.numpy()
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


@pytest.fixture(scope="module")
def jax_side():
    """(size, case) -> the JAX package's set-up, halo plan, assembled
    shard blocks, halo SpMV and IC(0) blocks, built once per module."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as Ps
    from pfemfort_tpu.drivers.sharded import \
        assemble_implicit_sharded_ell as j_assemble
    from pfemfort_tpu.elements import elasticity as jel
    from pfemfort_tpu.elements import poisson as jpo
    from pfemfort_tpu.mesh import generate as jgen
    from pfemfort_tpu.parallel.dist_ell import build_dist_ell_setup as j_setup
    from pfemfort_tpu.parallel.dist_ell import build_ell_halo as j_halo
    from pfemfort_tpu.parallel.dist_ell import spmv_ell_halo as j_spmv
    from pfemfort_tpu.solve.ic0 import build_ic0_shard_blocks as j_ic0

    class _Jax:
        poisson = staticmethod(jpo.poisson_element_matrices)
        elasticity = staticmethod(jel.elasticity_stiffness)
        dmat_3d = staticmethod(jel.dmat_3d)

    cache = {}

    def get(size, name):
        if (size, name) in cache:
            return cache[size, name]
        mesh, ndof, dbc, fbc, kind = _cases(jgen)[name]
        setup = j_setup(mesh, ndof, dbc, size)
        dm = jax.sharding.Mesh(np.array(jax.devices()[:size]), ("shard",))
        vals, b = j_assemble(setup, _element_fn(kind, _Jax), dm, jnp.float64,
                             fbc)
        cols_local, send_rows, wx = j_halo(setup)
        S, P, K = cols_local.shape
        spmv = jax.jit(jax.shard_map(
            lambda v, c, sr, x: j_spmv(v, c, sr, x, "shard"), mesh=dm,
            in_specs=(Ps("shard", None),) * 3 + (Ps("shard"),),
            out_specs=Ps("shard")))
        y = spmv(vals, jnp.asarray(cols_local.reshape(S * P, K)),
                 jnp.asarray(send_rows.reshape(S * S, wx)),
                 jnp.asarray(_x(S * P)))
        ic0 = j_ic0(cols_local, np.asarray(vals))
        cache[size, name] = dict(
            setup=setup, vals=np.asarray(vals), b=np.asarray(b),
            cols_local=cols_local, send_rows=send_rows, wx=wx,
            y=np.asarray(y), ic0=ic0)
        return cache[size, name]

    return get


CASES = ("poisson", "elasticity")


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("size", WORLDS)
def test_setup_arrays_equal_jax_bit_for_bit(ranks, jax_side, size, name):
    ref = jax_side(size, name)
    s_ = ref["setup"]
    jax_arrays = {"perm": s_.perm_s, "segids": s_.segids_s,
                  "recv_mat_dest": s_.recv_mat_dest,
                  "recv_rhs_dest": s_.recv_rhs_dest,
                  "coords": s_.coords_s, "ubc": s_.ubc_s}
    for r, res in enumerate(ranks[size]):
        for key in SETUP_KEYS:
            np.testing.assert_array_equal(res[f"{name}_{key}"],
                                          jax_arrays[key][r], err_msg=key)
        for key in ("w_mat", "w_rhs", "emax"):
            assert int(res[f"{name}_{key}"]) == getattr(s_, key), key
        np.testing.assert_array_equal(res[f"{name}_elem_owner"],
                                      s_.elem_owner)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("size", WORLDS)
def test_reader_plan_equals_jax(ranks, jax_side, size, name):
    ref = jax_side(size, name)
    for r, res in enumerate(ranks[size]):
        assert int(res[f"{name}_wx"]) == ref["wx"]
        np.testing.assert_array_equal(res[f"{name}_cols_local"],
                                      ref["cols_local"][r])
        np.testing.assert_array_equal(res[f"{name}_host_cols_local"],
                                      ref["cols_local"][r])
        np.testing.assert_array_equal(res[f"{name}_send_rows"],
                                      ref["send_rows"][r])


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("size", WORLDS)
def test_per_rank_ell_assembly_matches_jax(ranks, jax_side, size, name):
    ref = jax_side(size, name)
    P = ref["setup"].rows_per_shard
    assert np.abs(ref["vals"]).max() > 0 and np.abs(ref["b"]).max() > 0
    for r, res in enumerate(ranks[size]):
        sl = slice(r * P, (r + 1) * P)
        np.testing.assert_allclose(res[f"{name}_vals"], ref["vals"][sl],
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(res[f"{name}_b"], ref["b"][sl], rtol=0,
                                   atol=1e-12)
        assert res[f"{name}_repeat"]


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("size", WORLDS)
def test_spmv_ell_halo_matches_jax(ranks, jax_side, size, name):
    ref = jax_side(size, name)
    P = ref["setup"].rows_per_shard
    for r, res in enumerate(ranks[size]):
        np.testing.assert_allclose(res[f"{name}_y"],
                                   ref["y"][r * P:(r + 1) * P], rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("size", WORLDS)
def test_ic0_shard_blocks_match_jax(ranks, jax_side, size, name):
    t_cols, t_vals, tt_cols, tt_vals, dinv = jax_side(size, name)["ic0"]
    P, Kt = t_cols.shape[1:]
    for r, res in enumerate(ranks[size]):
        for key, jc, jv in (("t", t_cols, t_vals), ("tt", tt_cols, tt_vals)):
            c, v = res[f"{name}_ic0_{key}_cols"], res[f"{name}_ic0_{key}_vals"]
            assert c.shape[1] <= Kt
            pad = ((0, 0), (0, Kt - c.shape[1]))
            np.testing.assert_array_equal(
                np.pad(c, pad, constant_values=P), jc[r])
            np.testing.assert_allclose(np.pad(v, pad), jv[r], rtol=0,
                                       atol=1e-12)
        np.testing.assert_allclose(res[f"{name}_ic0_dinv"], dinv[r], rtol=0,
                                   atol=1e-12)


if __name__ == "__main__":      # one rank, as the `ranks` fixture starts it
    multihost.initialize(device="cpu")
    try:
        _ranks(sys.argv[1])
    finally:
        multihost.shutdown()
