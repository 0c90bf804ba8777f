"""Port parity: the elasticity element kernels and `solve_elasticity`.

The same element coordinates (generated meshes jittered from a seed with
numpy), displacements and loads go through the JAX package and the PyTorch
port in float64 on the CPU.

Tolerances: the element kernels sum the same products in the same order,
so they agree to round-off (relative 1e-12).  The solves must take the
JAX package's iteration count and give its u_full within 1e-10 of the
largest displacement; on the ELL path the port solves in a reordered row
space, so its count may differ by one (as for Poisson).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pfemfort_tpu as ft
import pfemfort_tpu_torch as pt
from pfemfort_tpu.drivers.common import _point_loads as j_point_loads
from pfemfort_tpu.drivers.common import solve_implicit as j_solve_implicit
from pfemfort_tpu.drivers.elasticity import solve_elasticity as j_solve
from pfemfort_tpu.dofs.dofmap import build_dofmap as j_build_dofmap
from pfemfort_tpu.elements import elasticity as je
from pfemfort_tpu.elements.geometry import to_element_minor
from pfemfort_tpu_torch import interop
from pfemfort_tpu_torch.assembly.pattern import build_pattern
from pfemfort_tpu_torch.dofs.dofmap import build_dofmap, reduced_lattice
from pfemfort_tpu_torch.drivers.common import _point_loads, solve_implicit
from pfemfort_tpu_torch.elements import elasticity as te

torch.set_num_threads(1)

RTOL = 1e-12
U_TOL = 1e-10

_MESHES = {
    "tria3": lambda: ft.generate.rect_tria(0, 1, 4, 0, 1, 3),
    "tria6": lambda: ft.generate.rect_tria6(0, 1, 3, 0, 1, 2),
    "quad4": lambda: ft.generate.rect_quad(0, 1, 4, 0, 1, 3),
    "tetra4": lambda: ft.generate.box_tet(0, 1, 2, 0, 1, 2, 0, 1, 3)[0],
    "prism6": lambda: ft.generate.box_prism(0, 1, 2, 0, 1, 3, 0, 1, 2),
    "hexa8": lambda: ft.generate.box_hexa(0, 1, 3, 0, 1, 2, 0, 1, 2),
}
ETYPES = sorted(_MESHES)


def _rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _inputs(etype, seed=0):
    """Jittered element coordinates, a D matrix, a body force and element
    displacements, all from one seed."""
    mesh = _MESHES[etype]()
    rng = np.random.default_rng(seed)
    em = to_element_minor(mesh.elem_coords())
    em = em + rng.uniform(-0.04, 0.04, em.shape)
    D = je.dmat_3d(200.0, 0.3) if mesh.ndim == 3 \
        else je.dmat_plane_strain(200.0, 0.3)
    b = rng.standard_normal(mesh.ndim)
    disp = rng.standard_normal((mesh.npe * mesh.ndim, mesh.n_elem))
    return em, D, b, disp


@pytest.mark.parametrize("fn,args", [
    ("dmat_plane_stress", (240.565, 0.3)), ("dmat_plane_strain", (200.0, 0.3)),
    ("dmat_3d", (2.1e7, 0.1)), ("dmat_3d", (1e9, 0.0))])
def test_dmat_matches_jax(fn, args):
    np.testing.assert_array_equal(getattr(te, fn)(*args),
                                  getattr(je, fn)(*args))


@pytest.mark.parametrize("etype", ETYPES)
def test_elasticity_stiffness_matches_jax(etype):
    em, D, b, _ = _inputs(etype)
    Kj, Fj = je.elasticity_stiffness(jnp.asarray(em), etype, D,
                                     thickness=0.7, bforce=b)
    Kt, Ft = te.elasticity_stiffness(torch.as_tensor(em), etype, D,
                                     thickness=0.7, bforce=b)
    assert Kt.shape == Kj.shape and Ft.shape == Fj.shape
    assert Kt.dtype == torch.float64 and Kt.is_contiguous()
    assert _rel_err(Kt, Kj) < RTOL
    assert _rel_err(Ft, Fj) < RTOL
    _, F0 = te.elasticity_stiffness(torch.as_tensor(em), etype, D)
    assert torch.count_nonzero(F0) == 0


@pytest.mark.parametrize("etype", ETYPES)
def test_elasticity_residual_matches_jax(etype):
    em, D, b, disp = _inputs(etype, seed=1)
    Rj = je.elasticity_residual(jnp.asarray(em), jnp.asarray(disp), etype, D,
                                7.6, jnp.asarray(b), thickness=0.5)
    Rt = te.elasticity_residual(torch.as_tensor(em), torch.as_tensor(disp),
                                etype, D, 7.6, torch.as_tensor(b),
                                thickness=0.5)
    assert Rt.shape == Rj.shape
    assert _rel_err(Rt, Rj) < RTOL


@pytest.mark.parametrize("etype", ETYPES)
def test_lumped_mass_matches_jax(etype):
    em, _, _, _ = _inputs(etype, seed=2)
    ndof = em.shape[1]
    for ngp in (None, 1):
        Mj = je.lumped_mass(jnp.asarray(em), etype, 1100.0, ndof, ngp=ngp)
        Mt = te.lumped_mass(torch.as_tensor(em), etype, 1100.0, ndof,
                            ngp=ngp)
        assert Mt.shape == Mj.shape
        assert _rel_err(Mt, Mj) < RTOL


def test_quad_hg_residual_matches_jax():
    em, _, b, disp = _inputs("quad4", seed=3)
    velo = np.random.default_rng(4).standard_normal(disp.shape)
    for E, nu, hg in ((1e9, 0.0, 1.0), (200.0, 0.3, 0.4)):
        Rj = je.quad_hg_residual(jnp.asarray(em), jnp.asarray(disp),
                                 jnp.asarray(velo), E, nu, 1000.0,
                                 jnp.asarray(b), hg_visc=hg)
        Rt = te.quad_hg_residual(torch.as_tensor(em), torch.as_tensor(disp),
                                 torch.as_tensor(velo), E, nu, 1000.0,
                                 torch.as_tensor(b), hg_visc=hg)
        assert _rel_err(Rt, Rj) < RTOL


# ---------------------------------------------------------------- solves


def _clamped(mesh, axis=0):
    """All components of the nodes on the face coords[:, axis] == min."""
    nodes = np.nonzero(mesh.coords[:, axis] == mesh.coords[:, axis].min())[0]
    d = mesh.ndim
    return np.stack([np.repeat(nodes, d), np.tile(np.arange(d), len(nodes)),
                     np.zeros(d * len(nodes))], 1).astype(np.float64)


def _edge_loads(mesh, value=1.0, comp=0):
    """Point loads on the nodes of the face coords[:, 0] == max."""
    nodes = np.nonzero(mesh.coords[:, 0] == mesh.coords[:, 0].max())[0]
    return np.stack([nodes, np.full(len(nodes), comp),
                     np.full(len(nodes), value)], 1).astype(np.float64)


def _renumbered(mesh, dbc, fbc, seed=0):
    perm = np.random.default_rng(seed).permutation(mesh.n_node)
    out = []
    for a in (dbc, fbc):
        a = a.copy()
        a[:, 0] = perm[a[:, 0].astype(np.int64)]
        out.append(a)
    return mesh.renumbered(perm.astype(np.int64)), out[0], out[1]


def _port_mesh(mesh):
    return interop.mesh_from_numpy(mesh.etype, mesh.coords, mesh.conn,
                                   mesh.structure)


def _assert_same(rt, rj, slack=0):
    assert rt.stats.converged and bool(rj.stats.converged)
    assert abs(rt.stats.iters - int(rj.stats.iters)) <= slack
    scale = np.abs(rj.u_full).max()
    assert np.abs(rt.u_full - rj.u_full).max() <= U_TOL * scale


def _problem(kind):
    if kind.startswith("2d"):
        mesh = ft.generate.rect_tria(0, 2, 12, 0, 1, 6)
        return mesh, _clamped(mesh), _edge_loads(mesh), None
    mesh, _ = ft.generate.box_tet(0, 1, 4, 0, 1, 3, 0, 1, 3)
    fbc = _edge_loads(mesh, value=0.01, comp=2)
    return mesh, _clamped(mesh), fbc, (0.1, 0.0, 0.0)


@pytest.mark.parametrize("kind", ["2d", "3d", "2d_plane_strain"])
def test_solve_elasticity_with_point_loads_matches_jax(kind):
    mesh, dbc, fbc, bforce = _problem(kind)
    kw = dict(force_bc=fbc, bforce=bforce, rtol=1e-10,
              plane="strain" if kind.endswith("strain") else "stress")
    rj = j_solve(mesh, dbc, 240.565, 0.3, **kw)
    rt = pt.solve_elasticity(_port_mesh(mesh), dbc, 240.565, 0.3,
                             dtype=torch.float64, **kw, device="cpu")
    _assert_same(rt, rj)
    assert "order_s" not in rt.timings      # the DIA pattern path
    assert np.abs(rt.u_full).max() > 0
    # the loads move the solution: without them it differs
    r0 = pt.solve_elasticity(_port_mesh(mesh), dbc, 240.565, 0.3,
                             bforce=bforce, rtol=1e-10, dtype=torch.float64,
                             device="cpu")
    assert np.abs(r0.u_full - rt.u_full).max() > 1e-3 * np.abs(
        rt.u_full).max()


@pytest.mark.parametrize("kind,recover", [("2d", True), ("2d", False),
                                          ("3d", True), ("3d", False)])
def test_renumbered_elasticity_matches_jax(kind, recover):
    """A renumbered mesh with loads: recovered to DIA (recover=True, the
    loads renumbered with it) or solved on the ELL path."""
    mesh, dbc, fbc, bforce = _problem(kind)
    mesh, dbc, fbc = _renumbered(ft.Mesh(mesh.etype, mesh.coords, mesh.conn),
                                 dbc, fbc)
    D = je.dmat_3d(240.565, 0.3) if mesh.ndim == 3 \
        else je.dmat_plane_stress(240.565, 0.3)
    rj = j_solve_implicit(
        mesh, mesh.ndim, dbc,
        lambda c: je.elasticity_stiffness(c, mesh.etype, D, bforce=bforce),
        force_bc=fbc, rtol=1e-10, recover=recover)
    rt = solve_implicit(
        _port_mesh(mesh), mesh.ndim, dbc,
        lambda c: te.elasticity_stiffness(c, mesh.etype, D, bforce=bforce),
        force_bc=fbc, dtype=torch.float64, rtol=1e-10, recover=recover,
                        device="cpu")
    _assert_same(rt, rj, slack=0 if recover else 1)
    assert rt.timings.get("structure_recovered", False) == recover
    assert ("order_s" in rt.timings) == (not recover)


def test_point_loads_match_jax_and_drop_dirichlet_rows():
    mesh, dbc, fbc, _ = _problem("2d")
    fbc = np.concatenate([fbc, fbc[:3], [[dbc[0, 0], dbc[0, 1], 5.0]]])
    jd, td = j_build_dofmap(mesh, 2, dbc), build_dofmap(_port_mesh(mesh), 2,
                                                        dbc)
    fj, ft_ = j_point_loads(jd, fbc), _point_loads(td, fbc)
    np.testing.assert_array_equal(ft_, fj)
    assert ft_.sum() == pytest.approx(len(fbc) - 1)   # the BC row dropped
    assert not _point_loads(td, None).any()


def test_elasticity_patch_test_is_exact():
    """All-face Dirichlet values of a linear displacement field and no body
    force: linear tets reproduce the field to round-off."""
    mesh, _ = pt.generate.box_tet(0, 1, 4, 0, 2, 3, 0, 1, 5)
    G = np.array([[1e-3, 2e-3, -1e-3], [0.5e-3, -2e-3, 1e-3],
                  [3e-3, 1e-3, 2e-3]])
    u_lin = mesh.coords @ G.T + np.array([1e-3, -2e-3, 0.5e-3])
    bd = pt.generate.boundary_nodes(mesh)
    dbc = np.stack([np.repeat(bd, 3), np.tile(np.arange(3), len(bd)),
                    u_lin[bd].reshape(-1)], 1)
    res = pt.solve_elasticity(mesh, dbc, 240.565, 0.3, rtol=1e-12,
                              dtype=torch.float64, device="cpu")
    assert res.stats.converged
    assert np.abs(res.u_full - u_lin.reshape(-1)).max() < 1e-12


@pytest.mark.parametrize("case,layout,width", [
    ("3d", "dia", 59), ("2d", "dia", 17), ("2d_renumbered", "ell", 16)])
def test_elasticity_patterns_have_the_kernel_widths(case, layout, width):
    """The systems the chip run drives reach B1 at 59 and 17 diagonals and
    B2 at K = 16 (a box_tet clamped on x=0, a clamped rect_tria, the same
    rect_tria with its nodes renumbered)."""
    if case == "3d":
        mesh, _ = pt.generate.box_tet(0, 1, 8, 0, 1, 8, 0, 1, 8)
    else:
        mesh = pt.generate.rect_tria(0, 2, 16, 0, 1, 8)
    dbc = _clamped(mesh)
    if case.endswith("renumbered"):
        mesh, dbc, _ = _renumbered(mesh, dbc, dbc[:0])
    dofmap = build_dofmap(mesh, mesh.ndim, dbc)
    pat = build_pattern(dofmap.elem_dof, dofmap.total_dof,
                        lattice=reduced_lattice(mesh, dofmap))
    assert pat.layout == layout
    assert (pat.n_offsets if layout == "dia" else pat.ell_k) == width


@pytest.mark.parametrize("option", [dict(refine=True), dict(bc_mode="full"),
                                    dict(precond="amg")])
def test_elasticity_options_outside_the_slice_raise(option):
    """These options no longer raise: each gives the JAX package's result
    on the loaded cantilever.  The reduced solve passes `precond` on (the
    JAX package's reduced elasticity is always Jacobi); SA-AMG cannot
    coarsen this 168-row system and falls back to Jacobi, as it says in
    precond_used, so precond='amg' gives the Jacobi solve bit for bit and
    the JAX package's result.  refine=True sums the
    float32 inner CG counts, which move with the order of the sums, so
    they may differ by 10%; both reach the true float64 rtol, and the
    solutions agree to the float64 solution's own accuracy."""
    mesh, dbc, fbc, _ = _problem("2d")
    kw = dict(force_bc=fbc, rtol=1e-10)
    rj = j_solve(mesh, dbc, 240.565, 0.3, **kw, **option)
    rt = pt.solve_elasticity(_port_mesh(mesh), dbc, 240.565, 0.3,
                             dtype=torch.float64, **kw, **option, device="cpu")
    if option.get("refine"):
        assert rt.stats.converged and bool(rj.stats.converged)
        assert rt.stats.relres <= 1e-10 and float(rj.stats.relres) <= 1e-10
        assert abs(rt.stats.iters - int(rj.stats.iters)) \
            <= 0.1 * int(rj.stats.iters)
        assert _rel_err(rt.u_full, rj.u_full) < 1e-8
        return
    _assert_same(rt, rj)
    if "precond" in option:
        r0 = pt.solve_elasticity(_port_mesh(mesh), dbc, 240.565, 0.3,
                                 dtype=torch.float64, **kw, device="cpu")
        assert rt.stats == r0.stats and "precond_used" not in r0.timings
        assert (rt.timings["precond_requested"],
                rt.timings["precond_used"]) == ("amg", "jacobi")
        np.testing.assert_array_equal(rt.u_full, r0.u_full)
