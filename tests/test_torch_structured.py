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
