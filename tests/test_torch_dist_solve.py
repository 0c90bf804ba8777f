"""Port parity: the sharded solves on 2, 4 and 8 gloo ranks.

Each world size is launched once (this file run as a script under
torchrun; the rank processes never import JAX) and runs, on every rank:
  * `solve_implicit_sharded` on the JAX package's multichip dry-run case
    (halo/dia: box_tet 4x4x(2*ranks), rtol 1e-6, recover=True, Jacobi): u
    within 1e-10 of the JAX package's solve, with the same iteration count;
  * `distributed_cg_solve`, the all-gather ELL route (B2 on the card), on
    the rcb-sharded ELL system of a 4x4x4 box, rtol 1e-11: x within 1e-10
    of JAX's, the same count;
  * a scrambled mesh (no per-rank DIA census, recover=False): it solves on
    the ELL route (parallel/dist_ell.py): u within 1e-10 of JAX's, the same
    count;
  * precond='mg' (the case that raised naming ROADMAP A.9c before the
    distributed multigrid was ported) on the 4x4x4 box, rtol 1e-8: the
    distributed MG route, u within 1e-10 of JAX's, the same count.
float64 throughout; the JAX side runs in this process under shard_map.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pfemfort_tpu_torch.assembly.assemble import assemble_ell_values, \
    assemble_rhs, build_assembly_plan, dirichlet_rhs_correction
from pfemfort_tpu_torch.drivers.sharded import solve_implicit_sharded
from pfemfort_tpu_torch.elements.geometry import to_element_minor
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
from pfemfort_tpu_torch.mesh import generate
from pfemfort_tpu_torch.parallel import multihost
from pfemfort_tpu_torch.parallel.shard import build_sharded_system
from pfemfort_tpu_torch.parallel.shard_cg import distributed_cg_solve

WORLDS = (2, 4, 8)


def _poisson(c, pkg_fn=poisson_element_matrices):
    return pkg_fn(c, "tetra4", source=-6.0)


def _scrambled(gen=generate):
    mesh, dbc = gen.box_tet(0, 1, 5, 0, 1, 5, 0, 1, 6)
    perm = np.random.default_rng(3).permutation(mesh.n_node)
    mesh = mesh.renumbered(perm.astype(np.int64))
    dbc = dbc.copy()
    dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    return mesh, dbc


def _ranks(outdir):
    import torch.distributed as dist

    assert "jax" not in sys.modules
    rank, size = dist.get_rank(), dist.get_world_size()
    out = {}
    mesh, dbc = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 2 * size)
    res = solve_implicit_sharded(mesh, 1, dbc, _poisson,
                                 dtype=torch.float64, rtol=1e-6,
                                 maxiter=500, device="cpu")
    out["halo_u"], out["halo_iters"] = res.u_full, res.stats.iters
    out["halo_layout"] = res.timings["assembly_layout"]
    out["halo_owner"] = res.elem_part

    mesh, dbc = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4)
    sys_ = build_sharded_system(mesh, 1, dbc, size, layout="ell")
    Ke, Fe = _poisson(torch.as_tensor(to_element_minor(mesh.elem_coords())))
    plan = build_assembly_plan(sys_.pattern, "cpu")
    A = assemble_ell_values(Ke, plan)
    ubc = torch.as_tensor(
        sys_.dofmap.bc_values_full[sys_.dofmap.elem_nodedof].T)
    b = assemble_rhs(Fe + dirichlet_rhs_correction(Ke, ubc), plan)
    P = sys_.rows_per_shard
    sl = slice(rank * P, (rank + 1) * P)
    x, st = distributed_cg_solve(A.cols[sl], A.vals[sl], b[sl], rtol=1e-11)
    out["ell_x"], out["ell_iters"] = x.numpy(), st.iters

    m, d = _scrambled()
    res = solve_implicit_sharded(m, 1, d, _poisson, dtype=torch.float64,
                                 recover=False, device="cpu")
    out["scrambled_u"], out["scrambled_iters"] = res.u_full, res.stats.iters
    out["scrambled_layout"] = res.timings["assembly_layout"]
    res = solve_implicit_sharded(mesh, 1, dbc, _poisson, dtype=torch.float64,
                                 rtol=1e-8, maxiter=60, device="cpu",
                                 precond="mg")
    out["mg_u"], out["mg_iters"] = res.u_full, res.stats.iters
    out["mg_route"] = bool(res.timings.get("distributed_mg"))
    out["mg_used"] = res.timings["precond_used"]
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


def _device_mesh(n):
    import jax

    return jax.sharding.Mesh(np.array(jax.devices()[:n]), ("shard",))


@pytest.mark.parametrize("size", WORLDS)
def test_halo_dia_solve_matches_jax(ranks, size):
    from pfemfort_tpu.drivers.sharded import solve_implicit_sharded as j_solve
    from pfemfort_tpu.elements.poisson import poisson_element_matrices as jp
    from pfemfort_tpu.mesh import generate as jgen

    mesh, dbc = jgen.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 2 * size)
    ref = j_solve(mesh, 1, dbc, lambda c: _poisson(c, jp),
                  device_mesh=_device_mesh(size), rtol=1e-6, maxiter=500)
    assert ref.timings["assembly_layout"] == "dia"
    for r in ranks[size]:
        assert str(r["halo_layout"]) == "dia"
        assert int(r["halo_iters"]) == int(ref.stats.iters)
        np.testing.assert_allclose(r["halo_u"], ref.u_full, rtol=0,
                                   atol=1e-10)
        np.testing.assert_array_equal(r["halo_owner"], ref.elem_part)
    u_exact = (mesh.coords ** 2).sum(axis=1)
    assert np.abs(ranks[size][0]["halo_u"] - u_exact).max() < 1e-4


@pytest.mark.parametrize("size", WORLDS)
def test_all_gather_ell_route_matches_jax(ranks, size):
    import jax.numpy as jnp
    from pfemfort_tpu.assembly.assemble import assemble_ell_values as j_ell
    from pfemfort_tpu.assembly.assemble import assemble_rhs as j_rhs
    from pfemfort_tpu.assembly.assemble import \
        dirichlet_rhs_correction as j_corr
    from pfemfort_tpu.elements.geometry import to_element_minor as j_em
    from pfemfort_tpu.elements.poisson import poisson_element_matrices as jp
    from pfemfort_tpu.mesh import generate as jgen
    from pfemfort_tpu.parallel.shard import build_sharded_system as j_build
    from pfemfort_tpu.parallel.shard_cg import distributed_cg_solve as j_cg
    from pfemfort_tpu.parallel.shard_cg import shard_arrays

    mesh, dbc = jgen.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4)
    sys_ = j_build(mesh, 1, dbc, size, layout="ell")
    Ke, Fe = _poisson(jnp.asarray(j_em(mesh.elem_coords())), jp)
    A = j_ell(Ke, sys_.pattern, jnp.asarray(sys_.pattern.ell_cols))
    ubc = jnp.asarray(sys_.dofmap.bc_values_full[sys_.dofmap.elem_nodedof].T)
    b = j_rhs(Fe + j_corr(Ke, ubc), sys_.pattern)
    dm = _device_mesh(size)
    x, st = j_cg(dm, *shard_arrays(dm, "shard", A.cols, A.vals, b),
                 rtol=1e-11)
    for r in ranks[size]:
        assert int(r["ell_iters"]) == int(np.asarray(st.iters))
        np.testing.assert_allclose(r["ell_x"], np.asarray(x), rtol=0,
                                   atol=1e-10)


@pytest.mark.parametrize("size", WORLDS)
def test_refusals_name_their_roadmap_item(ranks, size):
    """The name is the refusal this case checked before the distributed
    multigrid was ported; precond='mg' now solves, as JAX's does."""
    import jax.numpy as jnp
    from pfemfort_tpu.drivers.sharded import solve_implicit_sharded as j_solve
    from pfemfort_tpu.elements.poisson import poisson_element_matrices as jp
    from pfemfort_tpu.mesh import generate as jgen

    mesh, dbc = jgen.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4)
    ref = j_solve(mesh, 1, dbc, lambda c: _poisson(c, jp),
                  device_mesh=_device_mesh(size), dtype=jnp.float64,
                  rtol=1e-8, maxiter=60, precond="mg")
    assert ref.timings["distributed_mg"]
    for r in ranks[size]:
        assert bool(r["mg_route"]) and str(r["mg_used"]) == "mg"
        assert int(r["mg_iters"]) == int(np.asarray(ref.stats.iters))
        np.testing.assert_allclose(r["mg_u"], ref.u_full, rtol=0,
                                   atol=1e-10)


@pytest.mark.parametrize("size", WORLDS)
def test_scrambled_mesh_solves_on_the_ell_route(ranks, size):
    """The mesh whose solve raised before the ELL route existed."""
    from pfemfort_tpu.drivers.sharded import solve_implicit_sharded as j_solve
    from pfemfort_tpu.elements.poisson import poisson_element_matrices as jp
    from pfemfort_tpu.mesh import generate as jgen

    mesh, dbc = _scrambled(jgen)
    ref = j_solve(mesh, 1, dbc, lambda c: _poisson(c, jp),
                  device_mesh=_device_mesh(size), recover=False)
    assert ref.timings["assembly_layout"] == "ell"
    for r in ranks[size]:
        assert str(r["scrambled_layout"]) == "ell"
        assert int(r["scrambled_iters"]) == int(ref.stats.iters)
        np.testing.assert_allclose(r["scrambled_u"], ref.u_full, rtol=0,
                                   atol=1e-10)


if __name__ == "__main__":      # one rank, as the `ranks` fixture starts it
    multihost.initialize(device="cpu")
    try:
        _ranks(sys.argv[1])
    finally:
        multihost.shutdown()
