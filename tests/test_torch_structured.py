"""Port parity: structured slice-add assembly and the slice-only reduction.

The same element matrices, made from a seed with numpy or by the element
kernel, go through the JAX package and the PyTorch port in float64 on the
CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfemfort_tpu.assembly import structured as jst
from pfemfort_tpu.dofs.dofmap import build_dofmap, full_lattice, reduced_box
from pfemfort_tpu.elements.geometry import to_element_minor
from pfemfort_tpu.elements.poisson import poisson_element_matrices as j_pem
from pfemfort_tpu.mesh import generate
from pfemfort_tpu.sparse.dia import spmv_dia as j_spmv_dia
from pfemfort_tpu_torch.assembly import structured as tst
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices as t_pem
from pfemfort_tpu_torch.sparse.dia import spmv_dia as t_spmv_dia

torch.set_num_threads(1)

# The same adds in the same plan order, in float64.
RTOL = 1e-12


def _rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _random_elements(dims, ndof, seed):
    nex, ney, nez = dims
    E = nex * ney * nez * 6
    ns = 4 * ndof
    rng = np.random.default_rng(seed)
    return rng.standard_normal((ns, ns, E)), rng.standard_normal((ns, E))


@pytest.mark.parametrize("dims,ndof", [((3, 4, 5), 1), ((2, 2, 3), 3),
                                       ((6, 6, 6), 1)])
def test_structured_plan_identical(dims, ndof):
    pj = jst.build_structured_plan(*dims, ndof=ndof)
    pt = tst.build_structured_plan(*dims, ndof=ndof)
    for field in ("nex", "ney", "nez", "ndof", "offsets", "entries",
                  "rhs_entries"):
        assert getattr(pt, field) == getattr(pj, field), field


@pytest.mark.parametrize("dims,ndof", [((3, 4, 5), 1), ((2, 3, 2), 3)])
def test_assemble_structured_random_elements_match(dims, ndof):
    Ke, Fe = _random_elements(dims, ndof, seed=sum(dims) + ndof)
    pj = jst.build_structured_plan(*dims, ndof=ndof)
    pt = tst.build_structured_plan(*dims, ndof=ndof)
    Aj = jst.assemble_dia_structured(jnp.asarray(Ke), pj)
    At = tst.assemble_dia_structured(torch.as_tensor(Ke), pt)
    assert At.offsets == Aj.offsets and At.n_rows == Aj.n_rows
    assert At.lattice == Aj.lattice
    assert _rel_err(At.vals, Aj.vals) < RTOL
    bj = jst.assemble_rhs_structured(jnp.asarray(Fe), pj)
    bt = tst.assemble_rhs_structured(torch.as_tensor(Fe), pt)
    assert _rel_err(bt, bj) < RTOL


def _poisson_full(n_xyz, extent=(1.0, 1.0, 1.0)):
    nex, ney, nez = n_xyz
    mesh, dbc = generate.box_tet(0, extent[0], nex, 0, extent[1], ney,
                                 0, extent[2], nez)
    em = to_element_minor(mesh.elem_coords())
    return mesh, dbc, em


@pytest.mark.parametrize("n_xyz,extent", [((4, 4, 4), (1, 1, 1)),
                                          ((6, 6, 6), (1, 1, 1)),
                                          ((5, 7, 6), (1, 2, 0.5))])
def test_reduce_structured_system_matches(n_xyz, extent):
    mesh, dbc, em = _poisson_full(n_xyz, extent)
    dofmap = build_dofmap(mesh, 1, dbc)
    box, shape = reduced_box(mesh, dofmap), full_lattice(mesh)
    plan_j = jst.build_structured_plan(*n_xyz)
    plan_t = tst.build_structured_plan(*n_xyz)

    Kj, Fj = j_pem(jnp.asarray(em), "tetra4", source=-6.0)
    Aj, bj = jst.reduce_structured_system(
        jst.assemble_dia_structured(Kj, plan_j),
        jst.assemble_rhs_structured(Fj, plan_j), box, shape,
        jnp.asarray(dofmap.bc_values_full))

    Kt, Ft = t_pem(torch.as_tensor(em), "tetra4", source=-6.0)
    At, bt = tst.reduce_structured_system(
        tst.assemble_dia_structured(Kt, plan_t),
        tst.assemble_rhs_structured(Ft, plan_t), box, shape,
        torch.as_tensor(dofmap.bc_values_full))

    assert At.offsets == Aj.offsets and At.n_rows == Aj.n_rows
    assert At.lattice == Aj.lattice
    assert At.vals.is_contiguous()
    assert _rel_err(At.vals, Aj.vals) < RTOL
    assert _rel_err(bt, bj) < RTOL
    x = np.random.default_rng(1).standard_normal(At.n_rows)
    assert _rel_err(t_spmv_dia(At, torch.as_tensor(x)),
                    j_spmv_dia(Aj, jnp.asarray(x))) < RTOL


@pytest.mark.parametrize("n_chunks", [2, 3])
def test_assemble_structured_chunked_matches(n_chunks):
    n = 6
    mesh, _, em = _poisson_full((n, n, n))
    plan_j = jst.build_structured_plan(n, n, n)
    plan_t = tst.build_structured_plan(n, n, n)
    Aj, bj = jax.jit(lambda c: jst.assemble_structured_chunked(
        lambda e: j_pem(e, "tetra4", source=-6.0), c, plan_j, n_chunks)
    )(jnp.asarray(em))
    At, bt = tst.assemble_structured_chunked(
        lambda e: t_pem(e, "tetra4", source=-6.0), torch.as_tensor(em),
        plan_t, n_chunks)
    assert At.offsets == Aj.offsets and At.lattice == Aj.lattice
    assert _rel_err(At.vals, Aj.vals) < RTOL
    assert _rel_err(bt, bj) < RTOL
    # and the same system as the one-shot port assembler
    Kt, Ft = t_pem(torch.as_tensor(em), "tetra4", source=-6.0)
    assert _rel_err(At.vals, tst.assemble_dia_structured(Kt, plan_t).vals) \
        < RTOL
    assert _rel_err(bt, tst.assemble_rhs_structured(Ft, plan_t)) < RTOL


def test_assemble_structured_chunked_rejects_uneven_chunks():
    plan = tst.build_structured_plan(2, 2, 3)
    em = torch.zeros(4, 3, 2 * 2 * 3 * 6, dtype=torch.float64)
    with pytest.raises(ValueError):
        tst.assemble_structured_chunked(
            lambda e: t_pem(e, "tetra4"), em, plan, 2)


# ------------------------------------------------------------ 2D rect_tria


@pytest.mark.parametrize("dims,ndof", [((3, 4), 1), ((5, 2), 2), ((6, 6), 1)])
def test_structured_plan_2d_identical(dims, ndof):
    pj = jst.build_structured_plan_2d(*dims, ndof=ndof)
    pt_ = tst.build_structured_plan_2d(*dims, ndof=ndof)
    for field in ("nex", "ney", "ndof", "offsets", "entries", "rhs_entries"):
        assert getattr(pt_, field) == getattr(pj, field), field


@pytest.mark.parametrize("dims,ndof", [((4, 3), 1), ((3, 5), 2)])
def test_assemble_structured_2d_random_elements_match(dims, ndof):
    nex, ney = dims
    E, ns = nex * ney * 2, 3 * ndof
    rng = np.random.default_rng(nex * ney + ndof)
    Ke, Fe = rng.standard_normal((ns, ns, E)), rng.standard_normal((ns, E))
    pj = jst.build_structured_plan_2d(nex, ney, ndof=ndof)
    pt_ = tst.build_structured_plan_2d(nex, ney, ndof=ndof)
    Aj = jst.assemble_dia_structured_2d(jnp.asarray(Ke), pj)
    At = tst.assemble_dia_structured_2d(torch.as_tensor(Ke), pt_)
    assert At.offsets == Aj.offsets and At.n_rows == Aj.n_rows
    assert At.lattice == Aj.lattice
    assert _rel_err(At.vals, Aj.vals) < RTOL
    bj = jst.assemble_rhs_structured_2d(jnp.asarray(Fe), pj)
    bt = tst.assemble_rhs_structured_2d(torch.as_tensor(Fe), pt_)
    assert _rel_err(bt, bj) < RTOL


def _rect_tria_problem(nex, ney, extent=(1.0, 1.0)):
    mesh = generate.rect_tria(0, extent[0], nex, 0, extent[1], ney)
    bd = generate.boundary_nodes(mesh)
    X = mesh.coords[bd]
    dbc = np.stack([bd, np.zeros(len(bd)), X[:, 0] ** 2 - X[:, 1] ** 2], 1)
    return mesh, dbc


@pytest.mark.parametrize("dims,extent", [((6, 5), (1, 1)),
                                         ((9, 7), (2, 0.5))])
def test_reduce_structured_system_2d_matches(dims, extent):
    mesh, dbc = _rect_tria_problem(*dims, extent)
    dofmap = build_dofmap(mesh, 1, dbc)
    box, shape = reduced_box(mesh, dofmap), full_lattice(mesh)
    assert box is not None and len(shape) == 2
    em = to_element_minor(mesh.elem_coords())
    plan_j = jst.build_structured_plan_2d(*dims)
    plan_t = tst.build_structured_plan_2d(*dims)
    Kj, Fj = j_pem(jnp.asarray(em), "tria3", source=1.5)
    Aj, bj = jst.reduce_structured_system(
        jst.assemble_dia_structured_2d(Kj, plan_j),
        jst.assemble_rhs_structured_2d(Fj, plan_j), box, shape,
        jnp.asarray(dofmap.bc_values_full))
    Kt, Ft = t_pem(torch.as_tensor(em), "tria3", source=1.5)
    At, bt = tst.reduce_structured_system(
        tst.assemble_dia_structured_2d(Kt, plan_t),
        tst.assemble_rhs_structured_2d(Ft, plan_t), box, shape,
        torch.as_tensor(dofmap.bc_values_full))
    assert At.offsets == Aj.offsets and At.lattice == Aj.lattice
    assert _rel_err(At.vals, Aj.vals) < RTOL
    assert _rel_err(bt, bj) < RTOL
    x = np.random.default_rng(2).standard_normal(At.n_rows)
    assert _rel_err(t_spmv_dia(At, torch.as_tensor(x)),
                    j_spmv_dia(Aj, jnp.asarray(x))) < RTOL


@pytest.mark.parametrize("dims", [(8, 6), (16, 16)])
def test_rect_tria_poisson_takes_the_structured_path_like_jax(dims):
    """A generated rect_tria Poisson mesh with a free box takes the 2D
    structured assembly in both packages, with the same solve."""
    import pfemfort_tpu as ft
    import pfemfort_tpu_torch as ptp
    from pfemfort_tpu.drivers.common import build_reduced_assembler as j_bra
    from pfemfort_tpu_torch.dofs.dofmap import build_dofmap as t_bdm
    from pfemfort_tpu_torch.drivers.common import build_reduced_assembler

    mesh, dbc = _rect_tria_problem(*dims)
    tmesh = ptp.generate.rect_tria(0, 1, dims[0], 0, 1, dims[1])
    fn = lambda c: t_pem(c, "tria3", source=1.0)
    asm = build_reduced_assembler(tmesh, 1, t_bdm(tmesh, 1, dbc,
                                                  with_elem=False),
                                  fn, torch.float64, "cpu")
    assert not hasattr(asm, "pattern")          # no pattern: structured
    j_asm, _ = j_bra(mesh, 1, build_dofmap(mesh, 1, dbc),
                     lambda c: j_pem(c, "tria3", source=1.0), jnp.float64)
    assert not hasattr(j_asm, "pattern")
    em = to_element_minor(mesh.elem_coords())
    (At, bt), (Aj, bj) = asm(torch.as_tensor(em)), j_asm(jnp.asarray(em))
    assert At.offsets == Aj.offsets and At.lattice == Aj.lattice
    assert _rel_err(At.vals, Aj.vals) < RTOL and _rel_err(bt, bj) < RTOL
    rj = ft.solve_poisson(mesh, dbc, source=1.0, rtol=1e-11)
    rt = ptp.solve_poisson(tmesh, dbc, source=1.0, rtol=1e-11,
                           dtype=torch.float64, device="cpu")
    assert rt.stats.iters == int(rj.stats.iters)
    assert np.abs(rt.u_full - rj.u_full).max() < 1e-10
    assert set(rt.timings) == {"pattern_s", "assemble_s", "solve_s",
                               "pattern.dofmap_s", "pattern.coords_s",
                               "krylov.loop_s", "krylov.wait_s",
                               "krylov.host_reads"}
