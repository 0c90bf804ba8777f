"""Kernel B3 (csrc/explicit_step.cu) against the explicit loop's plain step.

B3 rounds each product and sum where the plain step's torch ops round them,
and sums in the CPU's order, so from the same inputs its passes give the
plain step's bits on the CPU in float32 and float64, and so does a whole
run (its lumped mass summed in that order too).  The quad4 hourglass
residual has an element pass of its own (`HourglassPass`), held to
`quad_hg_residual` the same way, and its node pass takes the update in
velocity form, held to the plain step's.  A card run of each element path (tria3,
tetra4 and the hourglass quad4) is also held to the JAX package's own run,
which the card cannot make, through the file tests/explicit_reference.py
reads, at the CPU parity tests' 1e-10.

Marked `cuda`: each test skips without a CUDA device.  This file imports no
JAX, so it runs where JAX is not installed:

    python -m pytest -o addopts="" --noconftest -m cuda \
        tests/test_torch_explicit_cuda.py
"""

import numpy as np
import pytest
import torch

import explicit_reference

from pfemfort_tpu_torch import generate
from pfemfort_tpu_torch.assembly.assemble import Segments
from pfemfort_tpu_torch.dofs.dofmap import build_dofmap
from pfemfort_tpu_torch.dynamics import explicit_cuda
from pfemfort_tpu_torch.dynamics.checkpoint import ExplicitState
from pfemfort_tpu_torch.dynamics.explicit import explicit_dynamics
from pfemfort_tpu_torch.elements.elasticity import apply_residual, dmat_3d, \
    dmat_plane_strain, dmat_plane_stress, quad_hg_residual, \
    quad_hg_viscosity, residual_geometry
from pfemfort_tpu_torch.elements.geometry import to_element_minor

pytestmark = pytest.mark.cuda

MESHES = {
    "tria3": lambda: generate.rect_tria(0, 2, 24, 0, 1, 10),
    "tria6": lambda: generate.rect_tria6(0, 2, 12, 0, 1, 5),
    "quad4": lambda: generate.rect_quad(0, 2, 24, 0, 1, 10),
    "prism6": lambda: generate.box_prism(0, 2, 8, 0, 1, 4, 0, 1, 4),
    "tetra4": lambda: generate.box_tet(0, 2, 8, 0, 1, 4, 0, 1, 4)[0],
    "hexa8": lambda: generate.box_hexa(0, 2, 8, 0, 1, 4, 0, 1, 4),
}
DENS, DT, THICK = 7.6, 1e-3, 1.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _mesh(etype):
    mesh = MESHES[etype]()
    return mesh[0] if isinstance(mesh, tuple) else mesh


def _rel_err(y, y_ref):
    return float((y - y_ref).abs().max() / y_ref.abs().max())


def _setup(etype, device, dtype, seed=0, hourglass=None):
    """A mesh's B3 step with random state, and the plain pieces beside it;
    hourglass: the quad4 hourglass factor (the step's HourglassPass)."""
    mesh = _mesh(etype)
    nd, E = mesh.ndim, mesh.n_elem
    rng = np.random.default_rng(seed)
    as_dev = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    D = dmat_plane_stress(200.0, 0.3) if hourglass is not None else \
        dmat_plane_strain(200.0, 0.3) if nd == 2 else dmat_3d(2.1e7, 0.1)
    coords_em = as_dev(to_element_minor(mesh.elem_coords()))
    dofmap = build_dofmap(mesh, nd, np.zeros((0, 3)))
    dest = torch.as_tensor(dofmap.elem_nodedof.T.reshape(-1).astype(np.int64),
                           device=device)
    seg = Segments.from_dest(dest, mesh.n_node * nd + 1)
    n_full = mesh.n_node * nd
    mass_em = as_dev(rng.uniform(0.5, 2.0, (mesh.conn.shape[1] * nd, E)))
    free = torch.as_tensor(rng.random(n_full) < 0.8, device=device)
    fext = as_dev(rng.standard_normal(n_full))
    b = as_dev(rng.standard_normal(nd))
    conn_t = torch.as_tensor(mesh.conn, device=device).T.contiguous()
    step = explicit_cuda.ExplicitStep(
        coords_em, conn_t, mesh.etype, D, DENS, THICK, fext, free, mass_em,
        DT, lambda t: b, hourglass=hourglass)
    state = [as_dev(rng.standard_normal(n_full)) for _ in range(3)]
    return dict(mesh=mesh, D=D, coords_em=coords_em, dest=dest, seg=seg,
                mass_em=mass_em, free=free, fext=fext, b=b, step=step,
                state=state, as_dev=as_dev)


def _plain_update(s, fe_em, disp, disp_prev):
    """dynamics/explicit.py's plain update from element-minor forces."""
    as_dev = s["as_dev"]
    dtt, idtt, two_dt = as_dev(DT * DT), as_dev(1.0 / (DT * DT)), \
        as_dev(2.0 * DT)
    M = s["seg"].sum(s["mass_em"])
    upd = s["free"] & (M > 0)
    rhs = s["seg"].sum(fe_em) + s["fext"]
    rhs = rhs + idtt * M * (2.0 * disp - disp_prev)
    new = torch.where(upd, dtt * rhs / torch.where(M > 0, M, 1.0), 0.0)
    return new, (new - disp_prev) / two_dt


def _plain_velocity_update(s, fe_em, disp, w):
    """The plain step's velocity form (the hourglass quad4's) from
    element-minor forces and the half-step velocity w: (new, w_new, v)."""
    dt = s["as_dev"](DT)
    M = s["seg"].sum(s["mass_em"])
    upd = s["free"] & (M > 0)
    rhs = s["seg"].sum(fe_em) + s["fext"]
    w_new = torch.where(upd, w + dt * (rhs / torch.where(M > 0, M, 1.0)),
                        0.0)
    new = torch.where(upd, disp + dt * w_new, 0.0)
    return new, w_new, (w + w_new) * 0.5


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("etype", sorted(MESHES))
def test_element_pass_matches_apply_residual(cuda, etype, dtype):
    s = _setup(etype, cuda, dtype)
    before = s["step"].kernel.launches
    fe = s["step"].forces(s["state"][0], None, None).cpu()
    torch.cuda.synchronize()
    assert s["step"].kernel.launches == before + 1
    c = _setup(etype, "cpu", dtype)            # the same inputs on the CPU
    mesh, disp = c["mesh"], c["state"][0]
    npe, nd, E = mesh.conn.shape[1], mesh.ndim, mesh.n_elem
    geom = residual_geometry(c["coords_em"], mesh.etype)
    ref = apply_residual(geom, disp[c["dest"]].reshape(npe * nd, E), c["D"],
                         DENS, c["b"])
    assert torch.equal(fe, ref.reshape(npe, nd, E).permute(2, 0, 1)
                       .reshape(-1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("etype", ["tria6", "tetra4"])
def test_node_pass_matches_the_segment_sum_and_update(cuda, etype, dtype):
    s, c = (_setup(etype, d, dtype, seed=1) for d in (cuda, "cpu"))
    mesh = s["mesh"]
    ns, E = mesh.conn.shape[1] * mesh.ndim, mesh.n_elem
    fe = np.random.default_rng(2).standard_normal(E * ns)
    new, carry, velo = s["step"].update(s["as_dev"](fe), *s["state"][:2])
    ref_new, ref_velo = _plain_update(
        c, c["as_dev"](fe).reshape(E, ns).T.contiguous(), *c["state"][:2])
    assert carry is s["state"][0]          # u^n, the next step's u^{n-1}
    assert torch.equal(s["step"].mass.cpu(), c["seg"].sum(c["mass_em"]))
    assert torch.equal(new.cpu(), ref_new)
    assert torch.equal(velo.cpu(), ref_velo)
    fixed = ~c["free"]
    assert torch.equal(ref_new[fixed], torch.zeros_like(ref_new[fixed]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_hourglass_pass_matches_quad_hg_residual(cuda, dtype):
    """The hourglass pass gives quad_hg_residual's bits, element-major, from
    the same displacements, velocities and body force."""
    hg = quad_hg_viscosity(DENS)
    s = _setup("quad4", cuda, dtype, seed=4, hourglass=hg)
    step = s["step"]
    before = step.kernel.launches
    disp, _, velo = s["state"]
    fe = step.forces(disp, velo, None).cpu()
    torch.cuda.synchronize()
    assert step.kernel.launches == before + 1
    assert isinstance(step.element, explicit_cuda.HourglassPass)
    c = _setup("quad4", "cpu", dtype, seed=4, hourglass=hg)
    E, (disp, _, velo) = c["mesh"].n_elem, c["state"]
    ref = quad_hg_residual(c["coords_em"], disp[c["dest"]].reshape(8, E),
                           velo[c["dest"]].reshape(8, E), 200.0, 0.3, DENS,
                           c["b"], thickness=THICK)
    assert torch.equal(fe, ref.reshape(4, 2, E).permute(2, 0, 1)
                       .reshape(-1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_hourglass_node_pass_is_the_plain_velocity_form(cuda, dtype):
    """The hourglass step's node pass sums the element-major Fe in the
    plain step's order and takes the update in velocity form, from u and
    the half-step velocity w: the plain step's u, w and v, bit for bit."""
    rng = np.random.default_rng(3)
    s, c = (_setup("quad4", d, dtype, seed=3,
                   hourglass=quad_hg_viscosity(DENS)) for d in (cuda, "cpu"))
    ns, E = 8, s["mesh"].n_elem
    fe = rng.standard_normal(E * ns)
    new, w_new, velo = s["step"].update(s["as_dev"](fe), *s["state"][:2])
    ref = _plain_velocity_update(
        c, c["as_dev"](fe).reshape(E, ns).T.contiguous(), *c["state"][:2])
    for got, want in zip((new, w_new, velo), ref):
        assert torch.equal(got.cpu(), want)
    fixed = ~c["free"]
    assert not bool(ref[0][fixed].any()) and not bool(ref[1][fixed].any())


def _clamped(mesh):
    nodes = np.nonzero(mesh.coords[:, 0] == mesh.coords[:, 0].min())[0]
    d = mesh.ndim
    return np.stack([np.repeat(nodes, d), np.tile(np.arange(d), len(nodes)),
                     np.zeros(d * len(nodes))], 1).astype(np.float64)


def test_every_card_step_runs_through_the_kernel(cuda):
    mesh = _mesh("tetra4")
    b = torch.tensor([100.0, 0.0, 0.0], device=cuda)
    k = explicit_cuda.kernel(4, 3, 1, torch.float32)
    before = k.launches
    res = explicit_dynamics(mesh, _clamped(mesh), 2.1e7, 0.1, 7.6, 2e-5, 25,
                            bforce_fn=lambda t: b, device=cuda,
                            dtype=torch.float32)
    assert res.timings["explicit.kernel_steps"] == res.timings["steps"] == 25
    assert k.launches == before + 2 * 25
    assert k.entry_launches["explicit_step_node"] >= 25
    assert np.isfinite(res.disp).all() and np.abs(res.disp).max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("etype", sorted(MESHES))
def test_a_card_run_gives_the_cpus_bits(cuda, etype, dtype):
    """A run through a body-force pulse, with a nodal load and probes."""
    mesh = _mesh(etype)

    def bforce_fn(device):
        b = torch.tensor((1.0, -0.5, 0.25)[:mesh.ndim], dtype=dtype,
                         device=device)
        pulse = torch.tensor(15 * 2e-5, dtype=dtype, device=device)
        return lambda t: b * torch.where(t <= pulse, 1.0, 0.0)

    r_cpu, r_gpu = (explicit_dynamics(
        mesh, _clamped(mesh), 2.1e7, 0.1, 7.6, 2e-5, 40,
        bforce_fn=bforce_fn(d), force_bc=np.array([[mesh.n_node - 1, 1, 5.0]]),
        probe_dofs=(mesh.ndim + 1, mesh.n_node * mesh.ndim - 1), device=d,
        dtype=dtype) for d in ("cpu", cuda))
    assert r_gpu.timings["explicit.kernel_steps"] == 40
    for field in ("disp", "disp_prev", "velo", "acce", "probe_history"):
        np.testing.assert_array_equal(getattr(r_gpu, field),
                                      getattr(r_cpu, field))
    assert np.abs(r_cpu.disp).max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_card_set_up_counts_the_bytes_it_sends(cuda, dtype):
    """explicit.setup_h2d_bytes: the node coordinates, the connectivity
    (sent once for the gather, B3's plan and its element pass), the free
    mask, the loads, the probe ids and, resumed, the state."""
    mesh = _mesh("tetra4")
    n_full, size = mesh.n_node * 3, torch.empty((), dtype=dtype).itemsize
    run = lambda steps, **kw: explicit_dynamics(
        mesh, _clamped(mesh), 2.1e7, 0.1, 7.6, 2e-5, steps,
        probe_dofs=(4, 7), device=cuda, dtype=dtype, **kw)
    first = run(5)
    want = mesh.coords.size * size + mesh.conn.nbytes + n_full \
        + n_full * size + 2 * 8
    assert first.timings["explicit.setup_h2d_bytes"] == want
    resumed = run(5, init_state=ExplicitState(
        disp=first.disp, disp_prev=first.disp_prev, velo=first.velo,
        step=5))
    assert resumed.timings["explicit.setup_h2d_bytes"] == \
        want + 3 * n_full * size


def _hourglass_runs(cuda, dtype, steps):
    """The quad preset's run from rest under a point load, on the CPU and
    on the card, with B3's launches on the card counted."""
    from pfemfort_tpu_torch.drivers import presets as P

    p = P.QUAD_EXPLICIT
    mesh = generate.rect_quad(0, 10, 40, 0, 2, 8)
    loads = np.array([[mesh.n_node - 1, 1, 1e3]])
    run = lambda d: explicit_dynamics(
        mesh, _clamped(mesh), p.E, p.nu, p.dens, p.dt, steps, force_bc=loads,
        probe_dofs=(mesh.n_node * 2 - 1,), thickness=p.thickness,
        use_hourglass=True, device=d, dtype=dtype)
    r_cpu = run("cpu")
    k = explicit_cuda.kernel(4, 2, 1, dtype, hourglass=True)
    before = dict(k.entry_launches)
    r_gpu = run(cuda)
    launched = {n: k.entry_launches[n] - before.get(n, 0)
                for n in k.entry_launches}
    return r_cpu, r_gpu, launched


def test_hourglass_quad_on_the_card_matches_the_cpu_in_float64(cuda):
    r_cpu, r_gpu, _ = _hourglass_runs(cuda, torch.float64, 60)
    assert r_gpu.timings["explicit.kernel_steps"] == 60
    np.testing.assert_array_equal(r_gpu.disp, r_cpu.disp)
    assert np.abs(r_cpu.disp).max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_an_hourglass_card_run_gives_the_cpus_bits(cuda, dtype):
    """Each hourglass step on the card is one hourglass pass and one node
    pass, and the run gives the CPU's bits."""
    r_cpu, r_gpu, launched = _hourglass_runs(cuda, dtype, 80)
    t = r_gpu.timings
    assert t["explicit.kernel_steps"] == t["explicit.hg_kernel_steps"] == 80
    assert r_cpu.timings["explicit.hg_kernel_steps"] == 0
    assert launched == {"explicit_step_element": 80,
                        "explicit_step_node": 80}
    for field in ("disp", "disp_prev", "velo", "acce", "probe_history"):
        np.testing.assert_array_equal(getattr(r_gpu, field),
                                      getattr(r_cpu, field))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_resumed_hourglass_card_run_gives_the_cpus_bits(cuda, dtype):
    """Resumed from a moving state, the velocity form takes its half-step
    velocity from the state's u^n - u^{n-1} on the card as on the CPU."""
    from pfemfort_tpu_torch.drivers import presets as P

    p = P.QUAD_EXPLICIT
    mesh = generate.rect_quad(0, 10, 40, 0, 2, 8)
    loads = np.array([[mesh.n_node - 1, 1, 1e3]])
    run = lambda d, steps, **kw: explicit_dynamics(
        mesh, _clamped(mesh), p.E, p.nu, p.dens, p.dt, steps, force_bc=loads,
        thickness=p.thickness, use_hourglass=True, device=d, dtype=dtype,
        **kw)
    first = run("cpu", 40)
    state = ExplicitState(disp=first.disp, disp_prev=first.disp_prev,
                          velo=first.velo, step=40)
    r_cpu, r_gpu = (run(d, 40, init_state=state) for d in ("cpu", cuda))
    assert r_gpu.timings["explicit.hg_kernel_steps"] == 40
    for field in ("disp", "disp_prev", "velo", "acce"):
        np.testing.assert_array_equal(getattr(r_gpu, field),
                                      getattr(r_cpu, field))
    assert np.abs(r_cpu.velo).max() > 0


@pytest.mark.parametrize("name", explicit_reference.NAMES)
def test_a_card_run_meets_the_jax_package(cuda, name):
    case = explicit_reference.load(name)
    r = explicit_reference.run_port(case, cuda)
    assert r.timings["explicit.kernel_steps"] == int(case["nsteps"])
    for field in explicit_reference.FIELDS:
        assert explicit_reference.rel_err(getattr(r, field), case[field]) \
            < explicit_reference.RTOL, field
