"""Port parity: geometric multigrid (solve/multigrid.py) and the device
coordinate generator it uses (mesh/generate.py:box_tet_coords_em_device).

The same vectors (numpy, from a seed) and meshes go through both packages
in float64 on the CPU.  Tolerances: transfers 1e-14 (the same additions in
the same order); level operators, inverse diagonals, masks and the dense
coarsest inverse 1e-12 relative; one V-cycle 1e-12 relative, both on the
port's own hierarchy and on a JAX-built one carried over with
`interop.gmg_from_numpy`; MG-preconditioned CG takes JAX's iteration
count with u within 1e-10.  `coarsest_max_dof=64` makes small meshes
genuinely multilevel (three levels at box_tet n=8 and rect_tria 16x16).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pfemfort_tpu as ft
import pfemfort_tpu_torch as pt
from pfemfort_tpu.elements import elasticity as je
from pfemfort_tpu.elements.poisson import poisson_element_matrices as j_pem
from pfemfort_tpu.mesh import generate as jgen
from pfemfort_tpu.solve import multigrid as jmg
from pfemfort_tpu.solve.cg import cg_solve as j_cg
from pfemfort_tpu.sparse.ops import operator_and_diag as j_op
from pfemfort_tpu_torch import interop
from pfemfort_tpu_torch.elements import elasticity as te
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
from pfemfort_tpu_torch.mesh import generate as tgen
from pfemfort_tpu_torch.solve import multigrid as tmg
from pfemfort_tpu_torch.solve.cg import cg_solve as t_cg
from pfemfort_tpu_torch.sparse.ops import operator_and_diag as t_op

torch.set_num_threads(1)

TOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("fine_shape", [(5,), (9, 5), (5, 9, 7)])
@pytest.mark.parametrize("ndof", [1, 2, 3])
def test_transfers_match_jax_and_are_adjoint(fine_shape, ndof):
    rng = np.random.default_rng(len(fine_shape) * 10 + ndof)
    coarse_shape = tuple((s + 1) // 2 for s in fine_shape)
    uc = rng.standard_normal(int(np.prod(coarse_shape)) * ndof)
    vf = rng.standard_normal(int(np.prod(fine_shape)) * ndof)
    Pu_j = jmg.prolong(jnp.asarray(uc), coarse_shape, ndof)
    Rv_j = jmg.restrict(jnp.asarray(vf), fine_shape, ndof)
    Pu = tmg.prolong(torch.as_tensor(uc), coarse_shape, ndof)
    Rv = tmg.restrict(torch.as_tensor(vf), fine_shape, ndof)
    assert np.abs(Pu.numpy() - np.asarray(Pu_j)).max() < 1e-14
    assert np.abs(Rv.numpy() - np.asarray(Rv_j)).max() < 1e-14
    lhs, rhs = float(Pu @ torch.as_tensor(vf)), float(torch.as_tensor(uc) @ Rv)
    assert lhs == pytest.approx(rhs, rel=1e-12)
    for ax in range(len(fine_shape)):
        u = rng.standard_normal(coarse_shape)
        f = rng.standard_normal(fine_shape)
        np.testing.assert_array_equal(
            tmg.interp_axis(torch.as_tensor(u), ax).numpy(),
            np.asarray(jmg.interp_axis(jnp.asarray(u), ax)))
        np.testing.assert_array_equal(
            tmg.restrict_axis(torch.as_tensor(f), ax).numpy(),
            np.asarray(jmg.restrict_axis(jnp.asarray(f), ax)))


def test_interp_exact_on_linears():
    u = torch.as_tensor(2.0 * np.linspace(0, 1, 5) + 1.0)
    np.testing.assert_allclose(tmg.interp_axis(u, 0).numpy(),
                               2.0 * np.linspace(0, 1, 9) + 1.0, atol=1e-14)


@pytest.mark.parametrize("dims,box", [((3, 4, 5), (0, 1, 0, 2, 0, 1)),
                                      ((6, 2, 3), (-1, 2, 0.5, 1.5, 0, 3))])
def test_device_coords_match_jax_and_the_host_build(dims, box):
    nex, ney, nez = dims
    x0, x1, y0, y1, z0, z1 = box
    args = (x0, x1, nex, y0, y1, ney, z0, z1, nez)
    cj = np.asarray(jgen.box_tet_coords_em_device(*args, dtype=jnp.float64))
    ct = tgen.box_tet_coords_em_device(*args, dtype=torch.float64,
                                       device="cpu")
    host = tgen.box_tet_coords_em(*args, dtype=np.float64)
    assert ct.shape == (4, 3, 6 * nex * ney * nez) and ct.dtype == \
        torch.float64
    assert np.abs(ct.numpy() - cj).max() < 1e-14
    assert np.abs(ct.numpy() - host).max() < 1e-14
    c32 = tgen.box_tet_coords_em_device(*args, device="cpu")
    assert c32.dtype == torch.float32
    assert np.abs(c32.numpy() - host).max() < 1e-6


def _case(kind):
    """(JAX mesh, port mesh, ndof, bc mask of the full system, JAX and port
    element functions) of one structured problem."""
    if kind == "box":
        jm, jd = ft.generate.box_tet(0, 1, 8, 0, 1, 8, 0, 1, 8)
        tm, _ = pt.generate.box_tet(0, 1, 8, 0, 1, 8, 0, 1, 8)
        mask = np.zeros(jm.n_node, bool)
        mask[jd[:, 0].astype(int)] = True
        return (jm, tm, 1, mask, lambda c: j_pem(c, "tetra4", source=-6.0),
                lambda c: poisson_element_matrices(c, "tetra4", source=-6.0))
    if kind == "tria":
        jm = ft.generate.rect_tria(0, 1, 16, 0, 1, 16)
        tm = pt.generate.rect_tria(0, 1, 16, 0, 1, 16)
        mask = np.zeros(jm.n_node, bool)
        mask[ft.generate.boundary_nodes(jm)] = True
        return (jm, tm, 1, mask, lambda c: j_pem(c, "tria3"),
                lambda c: poisson_element_matrices(c, "tria3"))
    jm, _ = ft.generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4)
    tm, _ = pt.generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4)
    mask = np.repeat(np.isclose(jm.coords[:, 2], 0), 3)
    Dj, Dt = je.dmat_3d(210.0, 0.3), te.dmat_3d(210.0, 0.3)
    return (jm, tm, 3, mask, lambda c: je.elasticity_stiffness(c, "tetra4", Dj),
            lambda c: te.elasticity_stiffness(c, "tetra4", Dt))


KINDS = ["box", "tria", "elasticity"]


@functools.lru_cache(maxsize=None)
def _both_gmg(kind):
    """Both packages' hierarchies with coarsest_max_dof=64, built once per
    kind (the JAX package compiles each level: ~20 s a level for 3D
    elasticity on the CPU).  The elasticity chain stops at 3^3 nodes (81
    dofs > 64) and takes the Chebyshev coarse tail."""
    jm, tm, ndof, mask, jfn, tfn = _case(kind)
    # the JAX package's smoothing, which the port takes by default for
    # ndof = 1 only (see test_elasticity_mg_needs_its_own_smoothing)
    kw = dict(coarsest_max_dof=64, nu=1, omega=0.8)
    jb = jmg.build_gmg(jm, ndof, mask, jfn, dtype=jnp.float64, **kw)
    tb = tmg.build_gmg(tm, ndof, mask, tfn, dtype=torch.float64, **kw,
                       device="cpu")
    return jb, tb, mask


@pytest.mark.parametrize("kind", KINDS)
def test_build_gmg_levels_match_jax(kind):
    (ja, jmeta), (ta, tmeta), _ = _both_gmg(kind)
    assert dataclasses.astuple(tmeta) == dataclasses.astuple(jmeta)
    assert len(ta.mats) == len(ja.mats) >= 2
    for Aj, At in zip(ja.mats, ta.mats):
        assert At.offsets == tuple(Aj.offsets) and At.n_rows == Aj.n_rows
        assert At.lattice == (None if Aj.lattice is None
                              else tuple(Aj.lattice))
        assert _rel(At.vals, Aj.vals) < TOL
    for name in ("inv_diags", "masks"):
        for dj, dt in zip(getattr(ja, name), getattr(ta, name)):
            assert _rel(dt, dj) < TOL
    assert _rel(ta.coarse_inv, ja.coarse_inv) < 1e-10


@pytest.mark.parametrize("kind", KINDS)
def test_vcycle_matches_jax_on_both_hierarchies(kind):
    (ja, jmeta), (ta, tmeta), mask = _both_gmg(kind)
    carried = interop.gmg_from_numpy(ja, jmeta, dtype=torch.float64,
                                     device="cpu")
    r = np.random.default_rng(3).standard_normal(ta.mats[0].n_rows)
    r[mask] = 0.0
    zj = np.asarray(jmg.gmg_preconditioner(ja, jmeta)(jnp.asarray(r)))
    for arrays, meta in ((ta, tmeta), carried):
        zt = tmg.gmg_preconditioner(arrays, meta)(torch.as_tensor(r))
        assert _rel(zt, zj) < TOL


@pytest.mark.parametrize("kind", ["box", "tria"])
def test_mg_cg_iterations_match_jax_multilevel(kind):
    """CG on the symmetrized fine operator through three-level V-cycles:
    the same count and solution as JAX.  (3D elasticity is held per
    V-cycle above and end to end below: compiling JAX's CG loop around its
    Chebyshev-tailed cycle takes minutes on the CPU.)"""
    (ja, jmeta), (ta, tmeta), mask = _both_gmg(kind)
    rng = np.random.default_rng(4)
    x_star = rng.standard_normal(ta.mats[0].n_rows)
    x0 = np.where(mask, x_star, 0.0)
    op_j, _ = j_op(ja.mats[0])
    b = np.array(op_j(jnp.asarray(x_star)))
    uj, sj = j_cg(op_j, jnp.asarray(b), x0=jnp.asarray(x0),
                  precond=jmg.gmg_preconditioner(ja, jmeta), rtol=1e-10,
                  maxiter=100)
    op_t, _ = t_op(ta.mats[0])
    ut, st = t_cg(op_t, torch.as_tensor(b), x0=torch.as_tensor(x0),
                  precond=tmg.gmg_preconditioner(ta, tmeta), rtol=1e-10,
                  maxiter=100)
    assert st.converged and st.iters == int(sj.iters)
    assert np.abs(ut.numpy() - np.asarray(uj)).max() < 1e-10
    assert np.abs(ut.numpy() - x_star).max() < 1e-7


@pytest.mark.parametrize("kind", ["box8", "box16", "tria", "elasticity"])
def test_mg_solve_matches_jax(kind):
    """solve_poisson / solve_elasticity with bc_mode='full', precond='mg' at
    the default coarsest size (box_tet n=16 is two levels deep, the others
    fit the dense coarsest level)."""
    if kind.startswith("box"):
        n = int(kind[3:])
        jm, jd = ft.generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
        tm, td = pt.generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
        rj = ft.solve_poisson(jm, jd, bc_mode="full", precond="mg",
                              rtol=1e-10)
        rt = pt.solve_poisson(tm, td, bc_mode="full", precond="mg",
                              rtol=1e-10, dtype=torch.float64, device="cpu")
        assert np.abs(rt.u_full - (tm.coords ** 2).sum(1)).max() < 1e-7
    elif kind == "tria":
        jm = ft.generate.rect_tria(0, 1, 16, 0, 1, 16)
        tm = pt.generate.rect_tria(0, 1, 16, 0, 1, 16)
        bn = ft.generate.boundary_nodes(jm)
        x, y = jm.coords[bn, 0], jm.coords[bn, 1]
        uex = (np.cosh(np.pi * y) - np.sinh(np.pi * y) / np.tanh(np.pi)) \
            * np.sin(np.pi * x)
        dbc = np.stack([bn.astype(float), np.zeros(len(bn)), uex], 1)
        rj = ft.solve_poisson(jm, dbc, bc_mode="full", precond="mg",
                              rtol=1e-10)
        rt = pt.solve_poisson(tm, dbc, bc_mode="full", precond="mg",
                              rtol=1e-10, dtype=torch.float64, device="cpu")
    else:
        jm, _ = ft.generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4)
        tm, _ = pt.generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4)
        base = np.nonzero(np.isclose(jm.coords[:, 2], 0))[0]
        dbc = np.array([[n, d, 0.0] for n in base for d in (0, 1, 2)])
        fbc = np.array([[int(np.argmax(jm.coords.sum(axis=1))), 0, 1.0]])
        kw = dict(force_bc=fbc, rtol=1e-10, bc_mode="full", precond="mg")
        rj = ft.solve_elasticity(jm, dbc, 210.0, 0.3, **kw)
        rt = pt.solve_elasticity(tm, dbc, 210.0, 0.3, dtype=torch.float64,
                                 **kw, device="cpu")
    assert rt.stats.converged and rt.stats.iters == int(rj.stats.iters)
    assert np.abs(rt.u_full - rj.u_full).max() < 1e-10
    assert rt.timings["precond_used"] == "mg"


def test_mg_chebyshev_coarse_tail_matches_jax():
    """A chain stuck on an odd dimension above the dense-inverse cap (box
    n=10 with coarsest_max_dof=64: 6^3 = 216 > 64) takes a Chebyshev coarse
    solve, as in tests/test_multigrid.py."""
    jm, jd = ft.generate.box_tet(0, 1, 10, 0, 1, 10, 0, 1, 10)
    tm, _ = pt.generate.box_tet(0, 1, 10, 0, 1, 10, 0, 1, 10)
    mask = np.zeros(jm.n_node, bool)
    mask[jd[:, 0].astype(int)] = True
    ja, jmeta = jmg.build_gmg(jm, 1, mask, lambda c: j_pem(c, "tetra4"),
                              dtype=jnp.float64, coarsest_max_dof=64)
    ta, tmeta = tmg.build_gmg(tm, 1, mask,
                              lambda c: poisson_element_matrices(c, "tetra4"),
                              dtype=torch.float64, coarsest_max_dof=64,
                              device="cpu")
    assert tmeta.coarse_cheby is not None and ta.coarse_inv.shape == (1, 1)
    assert tmeta.coarse_cheby[2] == jmeta.coarse_cheby[2]
    assert abs(tmeta.coarse_cheby[0] - jmeta.coarse_cheby[0]) < 1e-12
    x_star = np.random.default_rng(0).standard_normal(ta.mats[0].n_rows)
    x0 = np.where(mask, x_star, 0.0)
    op_j, _ = j_op(ja.mats[0])
    b = np.array(op_j(jnp.asarray(x_star)))
    uj, sj = j_cg(op_j, jnp.asarray(b), x0=jnp.asarray(x0), rtol=1e-10,
                  precond=jmg.gmg_preconditioner(ja, jmeta), maxiter=60)
    op_t, _ = t_op(ta.mats[0])
    ut, st = t_cg(op_t, torch.as_tensor(b), x0=torch.as_tensor(x0),
                  rtol=1e-10, precond=tmg.gmg_preconditioner(ta, tmeta),
                  maxiter=60)
    assert st.converged and st.iters == int(sj.iters) <= 30
    assert np.abs(ut.numpy() - np.asarray(uj)).max() < 1e-10
    assert np.abs(ut.numpy() - x_star).max() < 1e-7


def test_mg_falls_back_to_jacobi_on_an_unstructured_mesh():
    jm = ft.generate.rect_tria(0, 1, 6, 0, 1, 6)
    jm = ft.Mesh(jm.etype, jm.coords, jm.conn)
    bn = ft.generate.boundary_nodes(jm)
    dbc = np.stack([bn.astype(np.float64), np.zeros(len(bn)),
                    np.ones(len(bn))], axis=1)
    tm = interop.mesh_from_numpy(jm.etype, jm.coords, jm.conn)
    rj = ft.solve_poisson(jm, dbc, bc_mode="full", precond="mg", rtol=1e-10)
    rt = pt.solve_poisson(tm, dbc, bc_mode="full", precond="mg", rtol=1e-10,
                          dtype=torch.float64, device="cpu")
    assert rt.timings["precond_requested"] == "mg"
    assert rt.timings["precond_used"] == "jacobi"
    assert "mg_setup_s" not in rt.timings
    assert rt.stats.converged and rt.stats.iters == int(rj.stats.iters)
    np.testing.assert_allclose(rt.u_full, 1.0, atol=1e-8)


def test_elasticity_mg_needs_its_own_smoothing():
    """ROADMAP C: the JAX package's single-device multigrid smooths vector
    problems like Poisson (nu=1, omega=0.8), but lambda_max(D^-1 A) is ~3.4
    for 3D elasticity, so omega * lambda_max > 2 and the cycle is
    indefinite from two levels on: the port with that smoothing (the JAX
    cycle to 1e-12 above) does not converge; its default for ndof > 1
    (nu=2, omega = (4/3) / lambda_max) does, to the reduced solution."""
    import pfemfort_tpu_torch.drivers.common as dc

    mesh, _ = pt.generate.box_tet(0, 1, 16, 0, 1, 16, 0, 1, 16)
    left = np.nonzero(mesh.coords[:, 0] == 0)[0]
    dbc = np.stack([np.repeat(left, 3), np.tile(np.arange(3), len(left)),
                    np.zeros(3 * len(left))], 1).astype(np.float64)
    kw = dict(bforce=(0.1, 0.0, 0.0), rtol=1e-6, dtype=torch.float64)
    res = pt.solve_elasticity(mesh, dbc, 240.565, 0.3, bc_mode="full",
                              precond="mg", maxiter=200, **kw, device="cpu")
    assert res.timings["mg_levels"] == [14739, 2187]
    assert res.stats.converged and res.stats.iters <= 30
    ref = pt.solve_elasticity(mesh, dbc, 240.565, 0.3, **kw, device="cpu")
    assert np.abs(res.u_full - ref.u_full).max() < 1e-5 * np.abs(
        ref.u_full).max()
    jax_like = functools.partial(tmg.build_gmg, nu=1, omega=0.8)
    orig, dc.build_gmg = dc.build_gmg, jax_like
    try:
        bad = pt.solve_elasticity(mesh, dbc, 240.565, 0.3, bc_mode="full",
                                  precond="mg", maxiter=200, **kw,
                                  device="cpu")
    finally:
        dc.build_gmg = orig
    assert not bad.stats.converged
