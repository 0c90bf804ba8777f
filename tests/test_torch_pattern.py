"""Port parity: pattern building, pattern assembly, row orderings and
structure recovery, all on the CPU in float64 against the JAX package.

Inputs are built once with numpy (the JAX package's mesh generator and DOF
map give the element DOF arrays) and handed to both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfemfort_tpu.assembly import assemble as jasm
from pfemfort_tpu.assembly.pattern import build_pattern as j_build_pattern
from pfemfort_tpu.dofs.dofmap import build_dofmap, reduced_lattice
from pfemfort_tpu.elements.geometry import to_element_minor
from pfemfort_tpu.elements.poisson import poisson_element_matrices
from pfemfort_tpu.mesh import generate
from pfemfort_tpu.mesh.core import Mesh as JMesh
from pfemfort_tpu.mesh import reorder as jreorder
from pfemfort_tpu.sparse import slotgather as jsg
from pfemfort_tpu_torch import interop
from pfemfort_tpu_torch.assembly import assemble as tasm
from pfemfort_tpu_torch.assembly.pattern import build_pattern
from pfemfort_tpu_torch.mesh import reorder as treorder
from pfemfort_tpu_torch.sparse import ordering

torch.set_num_threads(1)

# Assembly sums the same element entries in float64 (sorted segments in the
# port, scatter-adds in JAX): equal up to the order of a few additions.
ATOL = 1e-12


def _mesh(kind):
    """(mesh, dirichlet) of a small box_tet in one of three numberings/BC
    sets.  The permuted one is large enough (343 free rows) for its
    diagonal census to exceed the DIA limit of 128 offsets."""
    n = 7 if kind == "permuted" else 5
    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    if kind == "partial_dirichlet":
        dbc = dbc[dbc[:, 2] > 0.5]
    if kind == "permuted":
        perm = np.random.default_rng(0).permutation(mesh.n_node)
        mesh = mesh.renumbered(perm.astype(np.int64))
        dbc = dbc.copy()
        dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    return mesh, dbc


# (mesh kind, layout argument) -> the layout build_pattern picks
PATTERNS = {
    "lattice_dia": ("lattice", "auto", "dia"),
    "partial_dirichlet_dia": ("partial_dirichlet", "auto", "dia"),
    "permuted_ell": ("permuted", "auto", "ell"),
    "lattice_forced_ell": ("lattice", "ell", "ell"),
}


def _patterns(case):
    kind, layout, _ = PATTERNS[case]
    mesh, dbc = _mesh(kind)
    dm = build_dofmap(mesh, 1, dbc)
    lattice = reduced_lattice(mesh, dm)
    jp = j_build_pattern(dm.elem_dof, dm.total_dof, layout=layout,
                         lattice=lattice)
    tp = build_pattern(dm.elem_dof, dm.total_dof, layout=layout,
                       lattice=lattice)
    return mesh, dm, jp, tp


@pytest.mark.parametrize("case", list(PATTERNS))
def test_build_pattern_matches_jax_field_by_field(case):
    _, _, jp, tp = _patterns(case)
    assert tp.layout == PATTERNS[case][2]
    for f in dataclasses.fields(jp):
        a, b = getattr(jp, f.name), getattr(tp, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("case", list(PATTERNS))
def test_assembly_matches_jax(case):
    mesh, dm, jp, tp = _patterns(case)
    coords = to_element_minor(mesh.elem_coords())
    Ke, Fe = poisson_element_matrices(jnp.asarray(coords), "tetra4",
                                      source=-6.0)
    ubc = dm.bc_values_full[dm.elem_nodedof].T
    Aj = jasm.assemble_matrix(Ke, jp)
    Fj = Fe + jasm.dirichlet_rhs_correction(Ke, jnp.asarray(ubc))
    bj = jasm.assemble_rhs(Fj, jp)

    plan = tasm.build_assembly_plan(tp, "cpu")
    Ke_t = torch.as_tensor(np.array(Ke))
    corr = tasm.dirichlet_rhs_correction(Ke_t, torch.as_tensor(ubc))
    np.testing.assert_allclose(
        corr.numpy(), np.asarray(jasm.dirichlet_rhs_correction(
            Ke, jnp.asarray(ubc))), rtol=0, atol=ATOL)
    At = tasm.assemble_matrix(Ke_t, plan)
    bt = tasm.assemble_rhs(torch.as_tensor(np.array(Fe)) + corr, plan)
    np.testing.assert_allclose(At.vals.numpy(), np.asarray(Aj.vals),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=0, atol=ATOL)
    if tp.layout == "dia":
        assert (At.offsets, At.lattice) == (Aj.offsets, Aj.lattice)
    else:
        np.testing.assert_array_equal(At.cols.numpy(), np.asarray(Aj.cols))
        assert At.n_cols == Aj.n_cols


def test_pattern_from_numpy_assembles_like_the_port_pattern():
    mesh, dm, jp, tp = _patterns("permuted_ell")
    tp2 = interop.pattern_from_numpy(**dataclasses.asdict(jp))
    Ke = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (4, 4, mesh.n_elem)))
    a = tasm.assemble_matrix(Ke, tasm.build_assembly_plan(tp, "cpu"))
    b = tasm.assemble_matrix(Ke, tasm.build_assembly_plan(tp2, "cpu"))
    assert torch.equal(a.vals, b.vals) and torch.equal(a.cols, b.cols)


def test_assembly_repeats_bit_for_bit():
    mesh, dm, _, tp = _patterns("permuted_ell")
    plan = tasm.build_assembly_plan(tp, "cpu")
    Ke = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (4, 4, mesh.n_elem)), dtype=torch.float32)
    a, b = (tasm.assemble_matrix(Ke, plan).vals for _ in range(2))
    assert torch.equal(a, b)


@pytest.mark.parametrize("order_kind", ["none", "rcm", "lex"])
def test_orderings_and_permuted_cols_match_jax(order_kind):
    mesh, dm, jp, tp = _patterns("permuted_ell")
    rows = mesh.coords[dm.assy_for_soln]
    comp = dm.assy_for_soln % 1
    np.testing.assert_array_equal(
        ordering.rcm_order(tp.indptr, tp.indices, tp.n_rows),
        jsg.rcm_order(jp.indptr, jp.indices, jp.n_rows))
    np.testing.assert_array_equal(ordering.coord_lex_order(rows, comp),
                                  jsg.coord_lex_order(rows, comp))
    order = {"none": None,
             "rcm": jsg.rcm_order(jp.indptr, jp.indices, jp.n_rows),
             "lex": jsg.coord_lex_order(rows, comp)}[order_kind]
    got = ordering.permuted_sorted_cols(tp.ell_cols, tp.n_rows, order,
                                        tp.n_rows)
    want = jsg.permuted_sorted_cols(jp.ell_cols, jp.n_rows, order, jp.n_rows)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)


def test_recover_structure_gives_the_jax_permutation():
    mesh, dbc = _mesh("permuted")
    tmesh = interop.mesh_from_numpy(mesh.etype, mesh.coords, mesh.conn)
    rj = jreorder.recover_structure(mesh, 1, dbc)
    rt = treorder.recover_structure(tmesh, 1, dbc)
    assert rj is not None and rt is not None
    np.testing.assert_array_equal(rt[3], rj[3])
    np.testing.assert_array_equal(rt[0].conn, rj[0].conn)
    np.testing.assert_array_equal(rt[0].coords, rj[0].coords)
    np.testing.assert_array_equal(rt[1], rj[1])
    np.testing.assert_array_equal(rt[4].assy_for_soln, rj[4].assy_for_soln)
    # a lattice numbering is DIA-able as it stands: nothing to recover
    lm, ld = _mesh("lattice")
    tl = interop.mesh_from_numpy(lm.etype, lm.coords, lm.conn)
    assert treorder.recover_structure(tl, 1, ld) is None
    assert jreorder.recover_structure(
        JMesh(lm.etype, lm.coords, lm.conn), 1, ld) is None
