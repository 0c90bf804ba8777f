"""Port parity: `solve_implicit_sharded` on the ELL route, on 2, 4 and 8
gloo ranks.

Each world size is launched once (this file run as a script under
torchrun; the rank processes never import JAX) and solves, on every rank,
meshes without a per-rank DIA layout (recover=False where recovery would
renumber them back to one):
  * `dist/ell ic0`: the JAX package's multichip dry-run case (box_tet
    5x5x8 with its nodes permuted by default_rng(0), rtol 1e-6, per-rank
    IC(0));
  * `dist/ell jacobi`: the same mesh with Jacobi;
  * `beam bjacobi`: 3D elasticity on a scrambled tet beam with point
    loads, per-node block-Jacobi, rtol 1e-10 (a generated stand-in for the
    reference's beam3Dtet6366 mesh, which the JAX package's own test of
    this case reads);
  * `delaunay ic0`: a scrambled Delaunay tet mesh of the unit cube (the
    JAX package's test mesh), per-rank IC(0), rtol 1e-11 (recover=False:
    on 2 ranks the recovered numbering would take the DIA route);
and precond='amg' on the `dist/ell` mesh (the case that raised naming
ROADMAP A.9c before the distributed SA-AMG was ported): its 112 free rows
do not coarsen, so both packages run Jacobi and say so.
Against the JAX package's solve_implicit_sharded in this process (its
shard_map on virtual CPU devices), float64: u within 1e-10, the same
iteration count, layout 'ell', distributed assembly, the same elem_part.
"""

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
from pfemfort_tpu_torch.mesh.core import Mesh
from pfemfort_tpu_torch.parallel import multihost

WORLDS = (2, 4, 8)
E, NU = 240.565, 0.3


def _scramble(mesh, tables, seed):
    perm = np.random.default_rng(seed).permutation(mesh.n_node)
    out = [mesh.renumbered(perm.astype(np.int64))]
    for t in tables:
        t = t.copy()
        t[:, 0] = perm[t[:, 0].astype(np.int64)]
        out.append(t)
    return out


def _delaunay(mesh_cls):
    """tests/test_dist_ell.py's Delaunay case: a jittered 7^3 lattice of
    the unit cube, tetrahedralised, nodes permuted; u = x^2+y^2+z^2 on the
    hull."""
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


def _cases(gen=generate, mesh_cls=Mesh):
    """name -> (mesh, ndof, dbc, fbc, element kind, solve keywords)."""
    box, box_dbc = gen.box_tet(0, 1, 5, 0, 1, 5, 0, 1, 8)
    box, box_dbc = _scramble(box, [box_dbc], 0)
    beam, _ = gen.box_tet(0, 5, 10, 0, 1, 2, 0, 1, 2)
    X = beam.coords
    left = np.nonzero(X[:, 0] == 0.0)[0]
    right = np.nonzero(X[:, 0] == 5.0)[0]
    beam_dbc = np.array([[n, d, 0.0] for n in left for d in (0, 1, 2)])
    beam_fbc = np.array([[n, 2, -0.1] for n in right])
    beam, beam_dbc, beam_fbc = _scramble(beam, [beam_dbc, beam_fbc], 3)
    dl, dl_dbc = _delaunay(mesh_cls)
    box_kw = dict(rtol=1e-6, maxiter=500, recover=False)
    return {
        "dist/ell ic0": (box, 1, box_dbc, None, "poisson",
                         dict(box_kw, precond="ic0")),
        "dist/ell jacobi": (box, 1, box_dbc, None, "poisson",
                            dict(box_kw, precond="jacobi")),
        "beam bjacobi": (beam, 3, beam_dbc, beam_fbc, "elasticity",
                         dict(rtol=1e-10, recover=False, precond="bjacobi")),
        "delaunay ic0": (dl, 1, dl_dbc, None, "poisson",
                         dict(rtol=1e-11, recover=False, precond="ic0")),
    }


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
    rank = dist.get_rank()
    out = {}
    for i, (name, (mesh, ndof, dbc, fbc, kind, kw)) in enumerate(
            _cases().items()):
        res = solve_implicit_sharded(mesh, ndof, dbc,
                                     _element_fn(kind, _Torch),
                                     force_bc=fbc, dtype=torch.float64,
                                     device="cpu", **kw)
        out[f"u{i}"], out[f"iters{i}"] = res.u_full, res.stats.iters
        out[f"converged{i}"] = res.stats.converged
        out[f"owner{i}"] = res.elem_part
        for key in ("assembly_layout", "distributed_assembly",
                    "precond_used", "inshard_kernel"):
            out[f"{key}{i}"] = res.timings[key]
    mesh, ndof, dbc, _, _, kw = _cases()["dist/ell jacobi"]
    res = solve_implicit_sharded(mesh, 1, dbc, _element_fn("poisson", _Torch),
                                 dtype=torch.float64, device="cpu",
                                 **dict(kw, precond="amg"))
    out["amg_u"], out["amg_iters"] = res.u_full, res.stats.iters
    out["amg_used"] = res.timings["precond_used"]
    out["amg_requested"] = res.timings["precond_requested"]
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


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("size", WORLDS)
def test_ell_route_solve_matches_jax(ranks, size, name):
    import jax
    from pfemfort_tpu.drivers.sharded import solve_implicit_sharded as j_solve
    from pfemfort_tpu.elements import elasticity as jel
    from pfemfort_tpu.elements import poisson as jpo
    from pfemfort_tpu.mesh import generate as jgen
    from pfemfort_tpu.mesh.core import Mesh as JMesh

    class _Jax:
        poisson = staticmethod(jpo.poisson_element_matrices)
        elasticity = staticmethod(jel.elasticity_stiffness)
        dmat_3d = staticmethod(jel.dmat_3d)

    i = NAMES.index(name)
    mesh, ndof, dbc, fbc, kind, kw = _cases(jgen, JMesh)[name]
    dm = jax.sharding.Mesh(np.array(jax.devices()[:size]), ("shard",))
    ref = j_solve(mesh, ndof, dbc, _element_fn(kind, _Jax), device_mesh=dm,
                  force_bc=fbc, **kw)
    assert ref.timings["assembly_layout"] == "ell"
    assert bool(np.asarray(ref.stats.converged))
    for r in ranks[size]:
        assert str(r[f"assembly_layout{i}"]) == "ell"
        assert bool(r[f"distributed_assembly{i}"]) and bool(r[f"converged{i}"])
        assert str(r[f"inshard_kernel{i}"]) == "spmv_sliced"
        assert str(r[f"precond_used{i}"]) == ref.timings["precond_used"] \
            == kw["precond"]
        assert int(r[f"iters{i}"]) == int(np.asarray(ref.stats.iters))
        np.testing.assert_allclose(r[f"u{i}"], ref.u_full, rtol=0,
                                   atol=1e-10)
        np.testing.assert_array_equal(r[f"owner{i}"], ref.elem_part)
    if name.startswith("dist/ell"):     # nodally exact on the box
        u_exact = (mesh.coords ** 2).sum(axis=1)
        assert np.abs(ranks[size][0][f"u{i}"] - u_exact).max() < 1e-4


@pytest.mark.parametrize("size", WORLDS)
def test_amg_on_the_ell_route_raises_naming_its_item(ranks, size):
    """The name is the refusal this case checked before the distributed
    SA-AMG was ported; precond='amg' now runs as JAX's does (here the
    hierarchy does not coarsen, so both report and run Jacobi)."""
    import jax
    from pfemfort_tpu.drivers.sharded import solve_implicit_sharded as j_solve
    from pfemfort_tpu.elements import poisson as jpo
    from pfemfort_tpu.mesh import generate as jgen
    from pfemfort_tpu.mesh.core import Mesh as JMesh

    class _Jax:
        poisson = staticmethod(jpo.poisson_element_matrices)

    mesh, _, dbc, _, _, kw = _cases(jgen, JMesh)["dist/ell jacobi"]
    dm = jax.sharding.Mesh(np.array(jax.devices()[:size]), ("shard",))
    ref = j_solve(mesh, 1, dbc, _element_fn("poisson", _Jax),
                  device_mesh=dm, **dict(kw, precond="amg"))
    assert ref.timings["precond_used"] == "jacobi"
    for r in ranks[size]:
        assert str(r["amg_requested"]) == "amg"
        assert str(r["amg_used"]) == ref.timings["precond_used"]
        assert int(r["amg_iters"]) == int(np.asarray(ref.stats.iters))
        np.testing.assert_allclose(r["amg_u"], ref.u_full, rtol=0,
                                   atol=1e-10)


if __name__ == "__main__":      # one rank, as the `ranks` fixture starts it
    multihost.initialize(device="cpu")
    try:
        _ranks(sys.argv[1])
    finally:
        multihost.shutdown()
