"""Port parity: the full-size system with identity Dirichlet rows
(bc_mode='full', assembly/fullsystem.py and
drivers/common.py:solve_implicit_fullsystem).

Both packages run in float64 on the CPU on the same meshes and BC values.
`zero_dirichlet_rows` must give JAX's values exactly; each full-system
solve must take JAX's iteration count, give its solution within 1e-10,
match the reduced solve within 1e-8 (as the JAX package's own
tests/test_fullsystem.py holds) and carry the applied values on BC rows.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pfemfort_tpu as ft
import pfemfort_tpu_torch as pt
from pfemfort_tpu.assembly.fullsystem import zero_dirichlet_rows as j_zdr
from pfemfort_tpu.drivers.common import build_reduced_assembler as j_bra
from pfemfort_tpu.dofs.dofmap import build_dofmap as j_build_dofmap
from pfemfort_tpu.elements.geometry import to_element_minor
from pfemfort_tpu.elements.poisson import poisson_element_matrices as j_pem
from pfemfort_tpu.sparse.dia import DIAMatrix as JDIA
from pfemfort_tpu_torch import interop
from pfemfort_tpu_torch.assembly.fullsystem import zero_dirichlet_rows

torch.set_num_threads(1)


def _dbc_square(mesh, fn):
    b = pt.generate.boundary_nodes(mesh)
    return np.stack([b.astype(float), np.zeros(len(b)), fn(mesh.coords[b])],
                    axis=1)


def _port_mesh(mesh):
    return interop.mesh_from_numpy(mesh.etype, mesh.coords, mesh.conn,
                                   mesh.structure)


@pytest.mark.parametrize("renumber", [False, True])
def test_zero_dirichlet_rows_matches_jax(renumber):
    """On a DIA system and on an ELL one (the box renumbered from a seed):
    BC rows become identity rows, columns stay, b carries the values."""
    mesh, dbc = ft.generate.box_tet(0, 1, 7, 0, 1, 7, 0, 1, 7)
    if renumber:
        perm = np.random.default_rng(0).permutation(mesh.n_node)
        mesh = ft.Mesh(mesh.etype, mesh.coords, mesh.conn).renumbered(perm)
        dbc = dbc.copy()
        dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    dofmap = j_build_dofmap(mesh, 1, dbc)
    asm, _ = j_bra(mesh, 1, dofmap, lambda c: j_pem(c, "tetra4"),
                   jnp.float64)
    A, b = asm(jnp.asarray(to_element_minor(mesh.elem_coords())))
    rng = np.random.default_rng(1)
    mask = rng.random(A.n_rows) < 0.3
    vals = np.where(mask, rng.standard_normal(A.n_rows), 0.0)
    Aj, bj = j_zdr(A, b, jnp.asarray(mask), jnp.asarray(vals))
    if isinstance(A, JDIA):
        At = interop.dia_from_numpy(np.asarray(A.vals), A.offsets, A.n_rows,
                                    A.lattice, dtype=torch.float64,
                                    device="cpu")
    else:
        At = interop.ell_from_numpy(np.asarray(A.cols), np.asarray(A.vals),
                                    A.n_cols, dtype=torch.float64,
                                    device="cpu")
    assert isinstance(A, JDIA) != renumber
    At2, bt = zero_dirichlet_rows(At, torch.tensor(np.asarray(b)),
                                  torch.as_tensor(mask),
                                  torch.as_tensor(vals))
    np.testing.assert_array_equal(At2.vals.numpy(), np.asarray(Aj.vals))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))


@pytest.mark.parametrize("method", ["cg", "bicgstab", "gmres"])
def test_full_mode_matches_reduced_2d(method):
    mesh = pt.generate.rect_tria(0, 1, 8, 0, 1, 8)
    dbc = _dbc_square(mesh, lambda p: np.sin(np.pi * p[:, 0]) * (1 - p[:, 1]))
    jm = ft.generate.rect_tria(0, 1, 8, 0, 1, 8)
    rj = ft.solve_poisson(jm, dbc, rtol=1e-12, bc_mode="full", method=method)
    ref = pt.solve_poisson(mesh, dbc, rtol=1e-12, dtype=torch.float64,
                           device="cpu")
    res = pt.solve_poisson(mesh, dbc, rtol=1e-12, bc_mode="full",
                           method=method, dtype=torch.float64, device="cpu")
    assert res.stats.converged
    assert res.stats.iters == int(rj.stats.iters)
    assert np.abs(res.u_full - rj.u_full).max() < 1e-10
    assert np.allclose(res.u_full, ref.u_full, atol=1e-8)
    bn = dbc[:, 0].astype(int)
    assert np.allclose(res.u_full[bn], dbc[:, 2], atol=1e-12)
    assert res.u_reduced.shape == (mesh.n_node,)
    assert res.timings["precond_used"] == "jacobi"


def test_full_mode_matches_reduced_3d():
    jm, jd = ft.generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4)
    mesh, dbc = pt.generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4)
    rj = ft.solve_poisson(jm, jd, rtol=1e-11, bc_mode="full")
    ref = pt.solve_poisson(mesh, dbc, rtol=1e-11, dtype=torch.float64,
                           device="cpu")
    res = pt.solve_poisson(mesh, dbc, rtol=1e-11, bc_mode="full",
                           dtype=torch.float64, device="cpu")
    assert res.stats.converged and res.stats.iters == int(rj.stats.iters)
    assert np.abs(res.u_full - rj.u_full).max() < 1e-10
    assert np.allclose(res.u_full, ref.u_full, atol=1e-8)
    assert np.abs(res.u_full - (mesh.coords ** 2).sum(1)).max() < 1e-8


@pytest.mark.parametrize("renumber", [False, True])
def test_full_mode_on_the_pattern_path_matches_jax(renumber):
    """A mesh without generator structure takes the pattern assembly of all
    node-dofs (DIA, or ELL once renumbered), unordered as in JAX."""
    jm, jd = ft.generate.box_tet(0, 1, 6, 0, 1, 5, 0, 1, 4)
    jm = ft.Mesh(jm.etype, jm.coords, jm.conn)
    if renumber:
        perm = np.random.default_rng(2).permutation(jm.n_node)
        jm = jm.renumbered(perm)
        jd = jd.copy()
        jd[:, 0] = perm[jd[:, 0].astype(np.int64)]
    rj = ft.solve_poisson(jm, jd, rtol=1e-11, bc_mode="full")
    rt = pt.solve_poisson(_port_mesh(jm), jd, rtol=1e-11, bc_mode="full",
                          dtype=torch.float64, device="cpu")
    assert rt.stats.converged and rt.stats.iters == int(rj.stats.iters)
    assert np.abs(rt.u_full - rj.u_full).max() < 1e-10
    assert np.abs(rt.u_full - (jm.coords ** 2).sum(1)).max() < 1e-8


@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_full_mode_elasticity_with_point_loads_matches_jax(kind):
    if kind == "2d":
        jm = ft.generate.rect_tria(0, 2, 10, 0, 1, 5)
    else:
        jm, _ = ft.generate.box_tet(0, 1, 4, 0, 1, 2, 0, 1, 2)
    nd = jm.ndim
    left = np.nonzero(jm.coords[:, 0] == 0.0)[0]
    dbc = np.stack([np.repeat(left, nd), np.tile(np.arange(nd), len(left)),
                    np.zeros(nd * len(left))], 1).astype(np.float64)
    right = np.nonzero(jm.coords[:, 0] == jm.coords[:, 0].max())[0]
    fbc = np.stack([right, np.full(len(right), nd - 1),
                    np.full(len(right), -0.1)], 1).astype(np.float64)
    kw = dict(force_bc=fbc, rtol=1e-11, bc_mode="full")
    rj = ft.solve_elasticity(jm, dbc, 240.565, 0.3, **kw)
    rt = pt.solve_elasticity(_port_mesh(jm), dbc, 240.565, 0.3,
                             dtype=torch.float64, **kw, device="cpu")
    ref = pt.solve_elasticity(_port_mesh(jm), dbc, 240.565, 0.3,
                              force_bc=fbc, rtol=1e-11, dtype=torch.float64,
                              device="cpu")
    scale = np.abs(rj.u_full).max()
    assert rt.stats.converged and rt.stats.iters == int(rj.stats.iters)
    assert np.abs(rt.u_full - rj.u_full).max() < 1e-10 * scale
    assert np.abs(rt.u_full - ref.u_full).max() < 1e-7 * scale
