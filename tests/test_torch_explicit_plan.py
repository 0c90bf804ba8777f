"""Kernel B3's host side on the CPU: the node pass's int32 plan, made from
the connectivity alone (`node_plan_from_conn`), is the explicit loop's
sorted scatter (`Segments.from_dest`) on the whole mesh and on a sharded
rank's own elements, it refuses a mesh past int32 indexing, and a CPU run
records no kernel steps.  The hourglass quad4's pass is set up from
`quad_hg_geometry` with the residual's own scalars.  The kernel itself
runs only on the card (tests/test_torch_explicit_cuda.py)."""

import numpy as np
import pytest
import torch

from pfemfort_tpu_torch import explicit_dynamics, generate
from pfemfort_tpu_torch.assembly.assemble import Segments
from pfemfort_tpu_torch.dofs.dofmap import build_dofmap
from pfemfort_tpu_torch.dynamics import explicit_cuda
from pfemfort_tpu_torch.dynamics.sharded import build_sharded_explicit, \
    rank_conn_t
from pfemfort_tpu_torch.elements.elasticity import dmat_3d, \
    dmat_plane_strain, dmat_plane_stress, quad_hg_geometry, \
    quad_hg_viscosity
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


def _conn_t(mesh):
    """The connectivity as the explicit set-up sends it: (npe, E) int32."""
    return torch.as_tensor(mesh.conn).T.contiguous()


def _plan(mesh):
    return explicit_cuda.node_plan_from_conn(_conn_t(mesh), mesh.n_node,
                                             mesh.ndim)


def _per_dof(plan, n_node, nd, to_slot_entry):
    """The plan spread back over every dof: (perm, offsets) in the form of
    Segments, each entry mapped by to_slot_entry to slot * E + e."""
    off = plan.offsets.numpy().astype(np.int64)
    ent = plan.entries.numpy().astype(np.int64)
    perm, offsets = [], [0]
    for n in range(n_node):
        for c in range(nd):
            run = ent[off[n]:off[n + 1]] + c
            perm.append(to_slot_entry(run))
            offsets.append(offsets[-1] + len(run))
    offsets.append(offsets[-1])                # the dropped (BC) segment
    return np.concatenate(perm), np.asarray(offsets)


def _element_major_to_slot_entry(E, npe, nd):
    """(e * npe + i) * nd + c  ->  (i * nd + c) * E + e"""
    def to_slot_entry(a):
        e, r = a // (npe * nd), a % (npe * nd)
        return r * E + e
    return to_slot_entry


@pytest.mark.parametrize("etype", sorted(MESHES))
def test_node_plan_is_the_sorted_scatter(etype):
    mesh, seg = _scatter(etype)
    nd, E, npe = mesh.ndim, mesh.n_elem, mesh.conn.shape[1]
    plan = _plan(mesh)
    assert plan.offsets.dtype == plan.entries.dtype == torch.int32
    assert plan.offsets.numel() == mesh.n_node + 1
    assert plan.entries.numel() == E * npe

    perm, offsets = _per_dof(plan, mesh.n_node, nd,
                             _element_major_to_slot_entry(E, npe, nd))
    np.testing.assert_array_equal(perm, seg.perm.numpy())
    np.testing.assert_array_equal(offsets, seg.offsets.numpy())


# meshes the slab partition cuts along their longest axis, as the sharded
# explicit tests run them
SHARDED = {
    "tria3": lambda: generate.rect_tria(0, 1, 4, 0, 4, 12),
    "quad4": lambda: generate.rect_quad(0, 1, 4, 0, 4, 12),
    "tetra4": lambda: generate.box_tet(0, 1, 3, 0, 1, 3, 0, 3, 9)[0],
    "hexa8": lambda: generate.box_hexa(0, 1, 2, 0, 1, 2, 0, 3, 9),
}


@pytest.mark.parametrize("size, rank", [(1, 0), (2, 0), (2, 1), (4, 0),
                                        (4, 3)])
@pytest.mark.parametrize("etype", sorted(SHARDED))
def test_a_ranks_plan_is_its_sorted_scatter(etype, size, rank):
    """On a sharded rank's own k elements the plan from `rank_conn_t` is
    the sorted scatter of the rank's (ns, k) gather table into its
    extended vector (dynamics/sharded.py's card path)."""
    mesh = SHARDED[etype]()
    nd, npe = mesh.ndim, mesh.npe
    setup = build_sharded_explicit(mesh, nd, np.zeros((0, 3)), size, rank)
    ext = setup.rows_per_shard + 2 * setup.halo
    k = int(setup.wmask.sum())
    seg = Segments.from_dest(
        torch.as_tensor(setup.gather[:, :k]).reshape(-1), ext + 1)
    conn_t = torch.as_tensor(rank_conn_t(setup, nd))
    assert conn_t.dtype == torch.int32 and tuple(conn_t.shape) == (npe, k)
    plan = explicit_cuda.node_plan_from_conn(conn_t, ext // nd, nd)
    perm, offsets = _per_dof(plan, ext // nd, nd,
                             _element_major_to_slot_entry(k, npe, nd))
    np.testing.assert_array_equal(perm, seg.perm.numpy())
    np.testing.assert_array_equal(offsets, seg.offsets.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("etype", ["tria6", "quad4", "tetra4", "hexa8"])
def test_the_plans_order_is_the_segment_sums_bits(etype, dtype):
    """Summed in the plan's order one incidence after another, as the node
    pass sums, the values give Segments.sum's bits on the CPU."""
    mesh, seg = _scatter(etype)
    nd, E, npe = mesh.ndim, mesh.n_elem, mesh.conn.shape[1]
    fe_em = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (npe * nd, E)), dtype=dtype)
    sums = explicit_cuda.ordered_summer(_plan(mesh), nd)(
        fe_em.T.contiguous().reshape(-1))
    assert torch.equal(sums, seg.sum(fe_em))


@pytest.mark.parametrize("n_elem, npe, ndof, n_node", [
    (2**31 // 12 + 1, 4, 3, 1000),          # Fe entries past int32
    (1000, 4, 3, 2**31 // 3 + 1),            # dofs past int32
    (2**31 // 4, 8, 3, 2**27),              # hexa8 at a quarter of 2^31
])
def test_node_plan_refuses_past_int32(n_elem, npe, ndof, n_node):
    with pytest.raises(ValueError, match="int32"):
        # a connectivity of that shape with no storage
        explicit_cuda.node_plan_from_conn(
            torch.empty((npe, n_elem), dtype=torch.int32, device="meta"),
            n_node, ndof)


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
    assert res.timings["explicit.hg_kernel_steps"] == 0
    assert timing.RECENT[-1].timings is res.timings


def test_a_cpu_hourglass_run_records_no_kernel_steps():
    mesh = MESHES["quad4"]()
    res = explicit_dynamics(mesh, np.zeros((0, 3)), 1e9, 0.0, 1000.0, 1e-5,
                            3, force_bc=np.array([[mesh.n_node - 1, 1, 1e3]]),
                            thickness=0.025, use_hourglass=True,
                            device="cpu", dtype=torch.float64)
    assert res.timings["explicit.kernel_steps"] == 0
    assert res.timings["explicit.hg_kernel_steps"] == 0
    assert np.abs(res.disp).max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_hourglass_pass_reads_the_residuals_geometry(dtype):
    """The hourglass step's set-up, which builds nothing: its own library,
    the five values of geometry an element (dN/dx and dN/dy at nodes 0 and
    1, the area: quad_hg_geometry's, whose other rows are their negatives),
    the plane-stress D, the thickness and the hourglass factor in the
    working type, and the element-major node plan."""
    from pfemfort_tpu_torch.elements.geometry import to_element_minor

    mesh, seg = _scatter("quad4")
    n_full, E = mesh.n_node * 2, mesh.n_elem
    coords = torch.as_tensor(to_element_minor(mesh.elem_coords()),
                             dtype=dtype)
    D = dmat_plane_stress(1e9, 0.25)
    ones = torch.ones(n_full, dtype=dtype)
    hg = quad_hg_viscosity(1000.0)
    step = explicit_cuda.ExplicitStep(
        coords, _conn_t(mesh), "quad4", D, 1000.0, 0.025, ones * 0, ones > 0,
        torch.ones(8, E, dtype=dtype), 1e-5, lambda t: None, hourglass=hg)
    hp = step.element
    assert isinstance(hp, explicit_cuda.HourglassPass)
    assert step.kernel is hp.kernel is explicit_cuda.kernel(
        4, 2, 1, dtype, hourglass=True)
    assert step.kernel is not explicit_cuda.kernel(4, 2, 1, dtype)
    assert "-DB3_HG=1" in step.kernel.flags
    args, _ = step.kernel.entries["explicit_step_element"]
    assert args[6] is explicit_cuda.element_params(4, 2, 1, dtype, True)
    g = quad_hg_geometry(coords)
    assert torch.equal(hp.geom, torch.stack([g.dNdx[0], g.dNdx[1],
                                             g.dNdy[0], g.dNdy[1], g.area]))
    assert torch.equal(g.dNdx[2:], -g.dNdx[:2])
    assert torch.equal(g.dNdy[2:], -g.dNdy[:2])
    real = np.float32 if dtype == torch.float32 else np.float64
    np.testing.assert_array_equal(np.asarray(hp.params.D[:], real),
                                  D.reshape(-1).astype(real))
    assert (real(hp.params.thick), real(hp.params.hg), real(hp.params.dens)) \
        == (real(0.025), real(hg), real(1000.0))
    assert hp.params.n_elem == E and tuple(hp.fe.shape) == (E * 8,)
    assert real(step.node.dt) == real(1e-5)
    assert torch.equal(step.mass, seg.sum(torch.ones(8, E, dtype=dtype)))


def test_the_hourglass_pass_takes_quad4_alone():
    from pfemfort_tpu_torch.elements.geometry import to_element_minor

    mesh, _ = _scatter("tria3")
    coords = torch.as_tensor(to_element_minor(mesh.elem_coords()))
    with pytest.raises(ValueError, match="quad4"):
        explicit_cuda.HourglassPass(coords, _conn_t(mesh),
                                    dmat_plane_stress(1e9, 0.0), 1000.0,
                                    0.025, 12500.0, lambda t: None,
                                    mesh.n_node * 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_launch_parameters_are_the_entry_points_classes(dtype):
    """ctypes takes a structure argument only of the class its argtypes
    name: the step builds its parameters from the same classes."""
    k = explicit_cuda.kernel(4, 3, 1, dtype)
    element_args, _ = k.entries["explicit_step_element"]
    node_args, _ = k.entries["explicit_step_node"]
    assert element_args[6] is explicit_cuda.element_params(4, 3, 1, dtype)
    assert node_args[11] is explicit_cuda.node_params(dtype)
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
        coords, _conn_t(mesh), "tria6", D, 7.6, 0.5, ones * 0, ones > 0,
        torch.ones(12, mesh.n_elem, dtype=dtype), 1e-3, lambda t: None)
    real = np.float32 if dtype == torch.float32 else np.float64
    np.testing.assert_array_equal(np.asarray(step.element.params.D[:], real),
                                  D.reshape(-1).astype(real))
    _, wts, N, _ = tabulate_basis("tria6")
    np.testing.assert_array_equal(np.asarray(step.element.params.N[:], real),
                                  np.asarray(N).reshape(-1).astype(real))
    assert step.element.params.n_elem == mesh.n_elem
    assert real(step.element.params.dens) == real(7.6)
    assert (real(step.node.dt), real(step.node.dtt), real(step.node.idtt),
            real(step.node.two_dt)) == (real(1e-3), real(1e-6), real(1e6),
                                        real(2e-3))
    assert step.node.n_node == mesh.n_node
    assert torch.equal(step.mass, seg.sum(torch.ones(12, mesh.n_elem,
                                                     dtype=dtype)))
    assert step.upd.dtype == torch.uint8 and bool(step.upd.all())
    assert step.element.conn.dtype == torch.int32 and tuple(
        step.element.conn.shape) == (6, mesh.n_elem)
    assert tuple(step.element.gradN.shape) == (len(wts), 2, 6, mesh.n_elem)
    assert tuple(step.element.fe.shape) == (mesh.n_elem * 12,)


def test_the_node_pass_refuses_a_vector_it_cannot_read():
    mesh, _ = _scatter("tetra4")
    from pfemfort_tpu_torch.elements.geometry import to_element_minor

    n_full, f64 = mesh.n_node * 3, torch.float64
    coords = torch.as_tensor(to_element_minor(mesh.elem_coords()))
    step = explicit_cuda.ExplicitStep(
        coords, _conn_t(mesh), "tetra4", dmat_3d(2.1e7, 0.1), 7.6, 1.0,
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


def test_the_element_pass_refuses_a_connectivity_it_cannot_read():
    """The element pass reads (npe, E) int32 node ids on its own device."""
    from pfemfort_tpu_torch.elements.geometry import element_coords

    mesh, _ = _scatter("tetra4")
    coords = element_coords(mesh, torch.float64, "cpu")
    conn_t = _conn_t(mesh)
    for bad in (conn_t.long(), conn_t.T.contiguous(), conn_t[:, :-1],
                conn_t.to("meta")):
        with pytest.raises(ValueError, match="conn_t"):
            explicit_cuda.ElementPass(coords, bad, "tetra4",
                                      dmat_3d(2.1e7, 0.1), 7.6, 1.0,
                                      lambda t: None, mesh.n_node * 3)
