"""Kernel B3's host side on the CPU: the node pass's int32 plan is the
explicit loop's sorted scatter (`Segments.from_dest`), it refuses a mesh
past int32 indexing, and a CPU run records no kernel steps.  The kernel
itself runs only on the card (tests/test_torch_explicit_cuda.py)."""

import numpy as np
import pytest
import torch

from pfemfort_tpu_torch import explicit_dynamics, generate
from pfemfort_tpu_torch.assembly.assemble import Segments
from pfemfort_tpu_torch.dofs.dofmap import build_dofmap
from pfemfort_tpu_torch.dynamics import explicit_cuda
from pfemfort_tpu_torch.elements.elasticity import dmat_3d, \
    dmat_plane_strain
from pfemfort_tpu_torch.utils import timing

MESHES = {
    "tria3": lambda: generate.rect_tria(0, 1, 5, 0, 1, 4),
    "tria6": lambda: generate.rect_tria6(0, 1, 3, 0, 1, 2),
    "quad4": lambda: generate.rect_quad(0, 1, 5, 0, 1, 4),
    "prism6": lambda: generate.box_prism(0, 1, 3, 0, 1, 2, 0, 1, 2),
    "tetra4": lambda: generate.box_tet(0, 1, 3, 0, 1, 2, 0, 1, 2)[0],
    "hexa8": lambda: generate.box_hexa(0, 1, 3, 0, 1, 2, 0, 1, 2),
}


def _scatter(etype):
    mesh = MESHES[etype]()
    mesh = mesh[0] if isinstance(mesh, tuple) else mesh
    nd = mesh.ndim
    dofmap = build_dofmap(mesh, nd, np.zeros((0, 3)))
    dest = torch.as_tensor(dofmap.elem_nodedof.T.reshape(-1).astype(np.int64))
    return mesh, Segments.from_dest(dest, mesh.n_node * nd + 1)


def _per_dof(plan, mesh, to_slot_entry):
    """The plan spread back over every dof: (perm, offsets) in the form of
    Segments, each entry mapped by to_slot_entry to slot * E + e."""
    nd = mesh.ndim
    off = plan.offsets.numpy().astype(np.int64)
    ent = plan.entries.numpy().astype(np.int64)
    perm, offsets = [], [0]
    for n in range(mesh.n_node):
        for c in range(nd):
            run = ent[off[n]:off[n + 1]] + c * plan.cstride
            perm.append(to_slot_entry(run))
            offsets.append(offsets[-1] + len(run))
    offsets.append(offsets[-1])                # the dropped (BC) segment
    return np.concatenate(perm), np.asarray(offsets)


@pytest.mark.parametrize("element_major", [True, False])
@pytest.mark.parametrize("etype", sorted(MESHES))
def test_node_plan_is_the_sorted_scatter(etype, element_major):
    mesh, seg = _scatter(etype)
    nd, E, npe = mesh.ndim, mesh.n_elem, mesh.conn.shape[1]
    plan = explicit_cuda.node_plan(seg, E, npe, nd, mesh.n_node,
                                   element_major=element_major)
    assert plan.offsets.dtype == plan.entries.dtype == torch.int32
    assert plan.offsets.numel() == mesh.n_node + 1
    assert plan.entries.numel() == E * npe

    if element_major:
        # (e * npe + i) * nd + c  ->  (i * nd + c) * E + e
        def to_slot_entry(a):
            e, r = a // (npe * nd), a % (npe * nd)
            return r * E + e
    else:
        to_slot_entry = lambda a: a
    perm, offsets = _per_dof(plan, mesh, to_slot_entry)
    np.testing.assert_array_equal(perm, seg.perm.numpy())
    np.testing.assert_array_equal(offsets, seg.offsets.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("element_major", [True, False])
@pytest.mark.parametrize("etype", ["tria6", "quad4", "tetra4", "hexa8"])
def test_the_plans_order_is_the_segment_sums_bits(etype, element_major,
                                                  dtype):
    """Summed in the plan's order one incidence after another, as the node
    pass sums, the values give Segments.sum's bits on the CPU."""
    mesh, seg = _scatter(etype)
    nd, E, npe = mesh.ndim, mesh.n_elem, mesh.conn.shape[1]
    fe_em = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (npe * nd, E)), dtype=dtype)
    plan = explicit_cuda.node_plan(seg, E, npe, nd, mesh.n_node,
                                   element_major=element_major)
    laid_out = fe_em.T if element_major else fe_em
    sums = explicit_cuda.ordered_summer(plan, nd)(
        laid_out.contiguous().reshape(-1))
    assert torch.equal(sums, seg.sum(fe_em))


@pytest.mark.parametrize("n_elem, npe, ndof, n_node", [
    (2**31 // 12 + 1, 4, 3, 1000),          # Fe entries past int32
    (1000, 4, 3, 2**31 // 3 + 1),            # dofs past int32
    (2**31 // 4, 8, 3, 2**27),              # hexa8 at a quarter of 2^31
])
def test_node_plan_refuses_past_int32(n_elem, npe, ndof, n_node):
    with pytest.raises(ValueError, match="int32"):
        explicit_cuda.node_plan(None, n_elem, npe, ndof, n_node)


def test_node_plan_takes_the_largest_int32_mesh():
    explicit_cuda.check_int32((2**31 - 1) // 12, 4, 3, (2**31 - 1) // 3)


@pytest.mark.parametrize("ndim", [2, 3])
def test_the_kernel_takes_the_explicit_loops_D(ndim):
    D = dmat_plane_strain(200.0, 0.3) if ndim == 2 else dmat_3d(2.1e7, 0.1)
    np.testing.assert_array_equal(explicit_cuda._isotropic(D), D)
    D[0, -1] = 1.0
    with pytest.raises(ValueError, match="isotropic"):
        explicit_cuda._isotropic(D)


def test_a_cpu_run_records_no_kernel_steps():
    mesh, dbc = generate.box_tet(0, 1, 2, 0, 1, 2, 0, 1, 2)
    res = explicit_dynamics(mesh, dbc, 2.1e7, 0.1, 7.6, 2e-5, 5,
                            device="cpu", dtype=torch.float64)
    assert res.timings["steps"] == 5
    assert res.timings["explicit.kernel_steps"] == 0
    assert timing.RECENT[-1].timings is res.timings


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_launch_parameters_are_the_entry_points_classes(dtype):
    """ctypes takes a structure argument only of the class its argtypes
    name: the step builds its parameters from the same classes."""
    k = explicit_cuda.kernel(4, 3, 1, dtype)
    element_args, _ = k.entries["explicit_step_element"]
    node_args, _ = k.entries["explicit_step_node"]
    assert element_args[6] is explicit_cuda.element_params(4, 3, 1, dtype)
    assert node_args[10] is explicit_cuda.node_params(dtype)
    assert "-DB3_REAL=" + ("float" if dtype == torch.float32 else "double") \
        in k.flags


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_launch_parameters_carry_the_step(dtype):
    """The step's set-up, which builds nothing: D, the basis values, the
    density and the time-step scalars in the working type."""
    from pfemfort_tpu_torch.elements.basis import tabulate_basis
    from pfemfort_tpu_torch.elements.geometry import to_element_minor

    mesh, seg = _scatter("tria6")
    n_full = mesh.n_node * 2
    coords = torch.as_tensor(to_element_minor(mesh.elem_coords()),
                             dtype=dtype)
    D = dmat_plane_strain(200.0, 0.3)
    ones = torch.ones(n_full, dtype=dtype)
    step = explicit_cuda.ExplicitStep(
        coords, mesh.conn, "tria6", seg, D, 7.6, 0.5, ones * 0, ones > 0,
        torch.ones(12, mesh.n_elem, dtype=dtype), 1e-3, lambda t: None)
    real = np.float32 if dtype == torch.float32 else np.float64
    np.testing.assert_array_equal(np.asarray(step.element.params.D[:], real),
                                  D.reshape(-1).astype(real))
    _, wts, N, _ = tabulate_basis("tria6")
    np.testing.assert_array_equal(np.asarray(step.element.params.N[:], real),
                                  np.asarray(N).reshape(-1).astype(real))
    assert step.element.params.n_elem == mesh.n_elem
    assert real(step.element.params.dens) == real(7.6)
    assert (real(step.node.dtt), real(step.node.idtt),
            real(step.node.two_dt)) == (real(1e-6), real(1e6), real(2e-3))
    assert step.node.n_node == mesh.n_node and step.node.cstride == 1
    assert torch.equal(step.mass, seg.sum(torch.ones(12, mesh.n_elem,
                                                     dtype=dtype)))
    assert step.upd.dtype == torch.uint8 and bool(step.upd.all())
    assert step.element.conn.dtype == torch.int32 and tuple(
        step.element.conn.shape) == (6, mesh.n_elem)
    assert tuple(step.element.gradN.shape) == (len(wts), 2, 6, mesh.n_elem)
    assert tuple(step.element.fe.shape) == (mesh.n_elem * 12,)


def test_the_node_pass_refuses_a_vector_it_cannot_read():
    mesh, seg = _scatter("tetra4")
    from pfemfort_tpu_torch.elements.geometry import to_element_minor

    n_full, f64 = mesh.n_node * 3, torch.float64
    coords = torch.as_tensor(to_element_minor(mesh.elem_coords()))
    step = explicit_cuda.ExplicitStep(
        coords, mesh.conn, "tetra4", seg, dmat_3d(2.1e7, 0.1), 7.6, 1.0,
        torch.zeros(n_full, dtype=f64), torch.ones(n_full, dtype=torch.bool),
        torch.ones(12, mesh.n_elem, dtype=f64), 1e-3, lambda t: None)
    u = torch.zeros(n_full, dtype=f64)
    fe = torch.zeros(mesh.n_elem * 12, dtype=f64)
    for bad in (u.float(), u[:-1], torch.zeros(2 * n_full, dtype=f64)[::2]):
        with pytest.raises(ValueError, match="disp"):
            step.update(fe, bad, u)
    with pytest.raises(ValueError, match="fe"):
        step.update(fe[:-1], u, u)
    with pytest.raises(ValueError, match="disp"):
        step.forces(u[:-1], None, None)
