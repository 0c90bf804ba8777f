"""Port parity: mesh generator, DOF map, basis tables and element kernels.

The same inputs, made from a seed with numpy, go through the JAX package and
the PyTorch port in float64 on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfemfort_tpu.dofs import dofmap as jdofmap
from pfemfort_tpu.elements import basis as jbasis
from pfemfort_tpu.elements import quadrature as jquad
from pfemfort_tpu.elements.geometry import grads_and_det as j_grads_and_det
from pfemfort_tpu.elements.geometry import to_element_minor
from pfemfort_tpu.elements.poisson import poisson_element_matrices as j_pem
from pfemfort_tpu.mesh import generate as jgen
from pfemfort_tpu_torch import interop
from pfemfort_tpu_torch.dofs import dofmap as tdofmap
from pfemfort_tpu_torch.elements import basis as tbasis
from pfemfort_tpu_torch.elements import quadrature as tquad
from pfemfort_tpu_torch.elements.geometry import grads_and_det as t_grads_and_det
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices as t_pem
from pfemfort_tpu_torch.mesh import generate as tgen

torch.set_num_threads(1)

# Element kernels are the same elementwise float64 arithmetic on both sides;
# only the order of a few sums may differ.
RTOL = 1e-12


def _rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("dims", [(4, 4, 4), (3, 5, 2), (7, 6, 5)])
def test_box_tet_host_arrays_identical(dims):
    nex, ney, nez = dims
    args = (0.0, 1.0, nex, -1.0, 2.0, ney, 0.5, 1.5, nez)
    jm, jd = jgen.box_tet(*args)
    tm, td = tgen.box_tet(*args)
    np.testing.assert_array_equal(tm.coords, jm.coords)
    np.testing.assert_array_equal(tm.conn, jm.conn)
    np.testing.assert_array_equal(td, jd)
    assert tm.structure == jm.structure and tm.etype == jm.etype


def test_box_tet_coords_em_matches_gathered_coords():
    args = (0.0, 1.0, 3, 0.0, 2.0, 4, -1.0, 1.0, 5)
    mesh, _ = tgen.box_tet(*args)
    em = tgen.box_tet_coords_em(*args, dtype=np.float64)
    np.testing.assert_array_equal(em, to_element_minor(mesh.elem_coords()))
    np.testing.assert_array_equal(
        em, jgen.box_tet_coords_em(*args, dtype=np.float64))


@pytest.mark.parametrize("n", [4, 6])
def test_dofmap_fields_identical(n):
    jm, dbc = jgen.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    tm = interop.mesh_from_numpy(jm.etype, jm.coords, jm.conn, jm.structure)
    jmap = jdofmap.build_dofmap(jm, 1, dbc)
    tmap = tdofmap.build_dofmap(tm, 1, dbc)
    for field in ("node_type", "node_dof", "elem_dof", "elem_nodedof",
                  "assy_for_soln", "bc_values_full"):
        np.testing.assert_array_equal(getattr(tmap, field),
                                      getattr(jmap, field), err_msg=field)
    assert tmap.total_dof == jmap.total_dof
    assert tdofmap.full_lattice(tm) == jdofmap.full_lattice(jm)
    assert tdofmap.reduced_box(tm, tmap) == jdofmap.reduced_box(jm, jmap)
    assert (tdofmap.reduced_lattice(tm, tmap)
            == jdofmap.reduced_lattice(jm, jmap))
    u = np.random.default_rng(n).standard_normal(tmap.total_dof)
    np.testing.assert_array_equal(tmap.expand_solution(u),
                                  jmap.expand_solution(u))


def test_reduced_box_none_when_free_nodes_are_not_a_box():
    jm, dbc = jgen.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4)
    dbc = dbc[dbc[:, 2] > 0.5]          # drop part of the boundary
    tm = interop.mesh_from_numpy(jm.etype, jm.coords, jm.conn, jm.structure)
    tmap = tdofmap.build_dofmap(tm, 1, dbc)
    assert tdofmap.reduced_box(tm, tmap) is None
    assert jdofmap.reduced_box(jm, jdofmap.build_dofmap(jm, 1, dbc)) is None


@pytest.mark.parametrize("etype,ngp", [("tria3", None), ("tria6", None),
                                       ("quad4", None), ("tetra4", None),
                                       ("tetra4", 4), ("prism6", 6),
                                       ("hexa8", None)])
def test_quadrature_and_basis_tables_identical(etype, ngp):
    for a, b in zip(tbasis.tabulate_basis(etype, ngp),
                    jbasis.tabulate_basis(etype, ngp)):
        np.testing.assert_array_equal(a, b)
    shape = tbasis.QUAD_SHAPE[etype]
    count = ngp or tbasis.DEFAULT_NGP[etype]
    for a, b in zip(tquad.gauss_rule(shape, count),
                    jquad.gauss_rule(shape, count)):
        np.testing.assert_array_equal(a, b)


def _random_coords_em(etype, E, seed):
    """Element-minor coordinates of E distorted copies of the reference
    element (positive Jacobians)."""
    rng = np.random.default_rng(seed)
    ref = {"tria3": [[0, 0], [1, 0], [0, 1]],
           "quad4": [[-1, -1], [1, -1], [1, 1], [-1, 1]],
           "tetra4": [[1, 0, 0], [0, 1, 0], [0, 0, 0], [0, 0, 1]],
           "hexa8": [[x, y, z] for z in (-1, 1) for y in (-1, 1)
                     for x in (-1, 1)]}[etype]
    ref = np.asarray(ref, dtype=np.float64)
    coords = ref[None] * rng.uniform(0.5, 2.0, (E, 1, ref.shape[1])) \
        + 0.1 * rng.standard_normal((E,) + ref.shape) \
        + rng.standard_normal((E, 1, ref.shape[1]))
    return to_element_minor(coords)


@pytest.mark.parametrize("etype", ["tria3", "quad4", "tetra4", "hexa8"])
def test_grads_and_det_match(etype):
    em = _random_coords_em(etype, 64, seed=1)
    _, _, _, dNdu = jbasis.tabulate_basis(etype, None)
    gj, dj = j_grads_and_det(jnp.asarray(em), dNdu)
    gt, dt = t_grads_and_det(torch.as_tensor(em), dNdu)
    assert _rel_err(gt, gj) < RTOL
    assert _rel_err(dt, dj) < RTOL


@pytest.mark.parametrize("case", ["tetra4-const", "tetra4-callable",
                                  "tetra4-kappa-af", "tria3-const",
                                  "hexa8-callable"])
def test_poisson_element_matrices_match(case):
    etype, variant = case.split("-", 1)
    em = _random_coords_em(etype, 96, seed=2)
    kw = {"const": dict(source=-6.0),
          "callable": dict(source=lambda xg: xg[:, 0] ** 2 - 3.0 * xg[:, 1]),
          "kappa-af": dict(source=2.5, kappa=(1.0, 2.0, 0.5), af=0.75)}[variant]
    Kj, Fj = j_pem(jnp.asarray(em), etype, **kw)
    Kt, Ft = t_pem(torch.as_tensor(em), etype, **kw)
    assert Kt.shape == Kj.shape and Ft.shape == Fj.shape
    assert Kt.dtype == torch.float64
    assert _rel_err(Kt, Kj) < RTOL
    assert _rel_err(Ft, Fj) < RTOL


def test_poisson_element_matrices_on_box_tet_mesh():
    mesh, _ = jgen.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4)
    em = to_element_minor(mesh.elem_coords())
    Kj, Fj = j_pem(jnp.asarray(em), "tetra4", source=-6.0)
    Kt, Ft = t_pem(torch.as_tensor(em), "tetra4", source=-6.0)
    assert _rel_err(Kt, Kj) < RTOL
    assert _rel_err(Ft, Fj) < RTOL
    # float32 in, float32 out
    K32, F32 = t_pem(torch.as_tensor(em, dtype=torch.float32), "tetra4",
                     source=-6.0)
    assert K32.dtype == F32.dtype == torch.float32
    assert _rel_err(K32.double(), Kj) < 1e-5
