"""The port's hourglass quad4 explicit program against the benchmark's plain
reference (benchmark/reference/quad_hg.py), on the CPU, in float64.

The reference is written from the Fortran equations with none of the
port's code: the area by the shoelace formula, the midpoint gradients in
their cyclic form, the stress and the hourglass force as closed formulas,
the mass from the 2 x 2 Gauss rule, the assembly an index_add_.  So the
two agree to round-off and no further:

  * the element residual and the lumped mass, assembled, on jittered
    (non-parallelogram) quads with random displacements and velocities:
    1e-12 of the largest entry (a few dozen float64 operations an entry
    in either order of summation);
  * a whole run of explicit_dynamics(use_hourglass=True) under seeded point
    loads against the reference's time loop: 1e-9 of the largest
    displacement and velocity (300 steps of round-off, amplified by the
    central difference's 1/dt^2 cancellation).

The port takes the hourglass quad's step in velocity form (dynamics/
explicit.py), the reference in the Fortran's displacement form: the same
step in exact arithmetic.  In float32, the benchmark cell's precision, the
velocity form keeps the velocities that the displacement form rounds away,
which the reference's own loop in float32 shows beside it.

No JAX and no card.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pfemfort_tpu_torch import explicit_dynamics, generate
from pfemfort_tpu_torch.assembly.assemble import Segments
from pfemfort_tpu_torch.dynamics.checkpoint import ExplicitState
from pfemfort_tpu_torch.elements.elasticity import lumped_mass, \
    quad_hg_residual
from pfemfort_tpu_torch.elements.geometry import to_element_minor

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from benchmark.reference import quad_hg  # noqa: E402

E, NU, DENS, THICK, WAVES = 1e9, 0.25, 1000.0, 0.025, 50.0
SEEDS = [0, 1, 2]


def _mesh(seed, nx=7, ny=5):
    """A rect_quad with its interior nodes jittered by up to a fifth of a
    cell: general convex quads."""
    mesh = generate.rect_quad(0, 0.7, nx, 0, 0.5, ny)
    rng = np.random.default_rng(seed)
    X = mesh.coords.copy()
    inner = (X[:, 0] > 0) & (X[:, 0] < 0.7) & (X[:, 1] > 0) & (X[:, 1] < 0.5)
    X[inner] += rng.uniform(-0.02, 0.02, (int(inner.sum()), 2))
    return generate.Mesh("quad4", X, mesh.conn)


def _problem(mesh, nu=NU, dtype=torch.float64):
    return quad_hg.make_problem(
        torch.as_tensor(mesh.coords, dtype=dtype), torch.as_tensor(mesh.conn),
        E=E, nu=nu, dens=DENS, thick=THICK, waves=WAVES)


def _assemble(mesh, fe_em):
    """The (8, E) element-minor values summed into the full dof vector."""
    dofs = torch.as_tensor(mesh.conn.astype(np.int64))[:, :, None] * 2 \
        + torch.arange(2)
    out = torch.zeros(mesh.n_node * 2, dtype=fe_em.dtype)
    return out.index_add_(0, dofs.reshape(-1), fe_em.T.reshape(-1))


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("seed", SEEDS)
def test_the_residual_is_the_references(seed):
    mesh = _mesh(seed)
    rng = np.random.default_rng(100 + seed)
    n_full = mesh.n_node * 2
    u = torch.as_tensor(rng.standard_normal(n_full) * 1e-3)
    v = torch.as_tensor(rng.standard_normal(n_full))
    b = torch.as_tensor(rng.standard_normal(2))
    coords_em = torch.as_tensor(to_element_minor(mesh.elem_coords()))
    dest = (torch.as_tensor(mesh.conn.T.astype(np.int64))[:, None, :] * 2
            + torch.arange(2)[None, :, None]).reshape(8, -1)
    fe = quad_hg_residual(coords_em, u[dest], v[dest], E, NU, DENS, b,
                          thickness=THICK, wave_speed=WAVES)
    ref = quad_hg.residual(_problem(mesh), u, v, b)
    assert _rel(_assemble(mesh, fe), ref) <= 1e-12
    # and so does each of its three parts alone, the stress, the hourglass
    # force and the body force, whose scales differ by orders
    for part in ((u, 0 * v, 0 * b), (0 * u, v, 0 * b), (0 * u, 0 * v, b)):
        fe_p = quad_hg_residual(coords_em, part[0][dest], part[1][dest],
                                E, NU, DENS, part[2], thickness=THICK,
                                wave_speed=WAVES)
        ref_p = quad_hg.residual(_problem(mesh), *part)
        assert ref_p.abs().max() > 0
        assert _rel(_assemble(mesh, fe_p), ref_p) <= 1e-12


@pytest.mark.parametrize("seed", SEEDS)
def test_the_lumped_mass_is_the_references(seed):
    mesh = _mesh(seed)
    coords_em = torch.as_tensor(to_element_minor(mesh.elem_coords()))
    m = lumped_mass(coords_em, "quad4", DENS, 2, ngp=4)
    p = _problem(mesh)
    assert _rel(_assemble(mesh, m), p.mass) <= 1e-12
    # the row sums hold the plate's mass, with no thickness
    assert float(p.mass.sum()) / 2 == pytest.approx(DENS * 0.7 * 0.5,
                                                    rel=1e-12)


DT = 1e-5                       # the configuration's dt


def _plate(seed, nx=24, ny=8, h=0.006):
    """A plate of the configuration's cell size, its x = 0 edge clamped and
    three seeded transverse point loads on its free end: (mesh, dbc, loads,
    fext and the Dirichlet dofs for the plain reference)."""
    mesh = generate.rect_quad(0, nx * h, nx, 0, ny * h, ny)
    rng = np.random.default_rng(seed)
    end = np.arange(ny + 1) * (nx + 1) + nx
    nodes = end[rng.choice(ny + 1, 3, replace=False)]
    loads = np.stack([nodes, np.ones(3), 1e3 * rng.uniform(0.5, 2.0, 3)], 1)
    clamped = np.arange(ny + 1) * (nx + 1)
    dbc = np.stack([np.repeat(clamped, 2), np.tile([0, 1], ny + 1),
                    np.zeros(2 * (ny + 1))], 1).astype(np.float64)
    fext = torch.zeros(mesh.n_node * 2, dtype=torch.float64)
    fext[torch.as_tensor(nodes * 2 + 1)] = torch.as_tensor(loads[:, 2])
    bc = torch.as_tensor(np.stack([clamped * 2, clamped * 2 + 1], 1)
                         .reshape(-1))
    return mesh, dbc, loads, fext, bc


def _run(mesh, dbc, loads, steps, dtype, **kw):
    return explicit_dynamics(mesh, dbc, E, 0.0, DENS, DT, steps,
                             force_bc=loads, thickness=THICK,
                             use_hourglass=True, device="cpu", dtype=dtype,
                             **kw)


def _reference_loop(mesh, fext, bc, steps, dtype=torch.float64):
    """The plain reference's time loop from rest, all of it in `dtype`."""
    p = _problem(mesh, nu=0.0, dtype=dtype)
    z = torch.zeros(p.n_full, dtype=dtype)
    return quad_hg.explicit(p, quad_hg.State(z, z.clone(), z.clone()), steps,
                            DT, fext.to(dtype), bc)


@pytest.mark.parametrize("seed", SEEDS)
def test_a_cpu_run_is_the_references_loop(seed):
    """Seeded transverse point loads on the free end of a clamped plate, at
    the configuration's material and dt; probes the loaded nodes."""
    steps = 300
    mesh, dbc, loads, fext, bc = _plate(seed)
    res = _run(mesh, dbc, loads, steps, torch.float64)
    ref = _reference_loop(mesh, fext, bc, steps)
    assert _rel(torch.as_tensor(res.disp), ref.disp) <= 1e-9
    assert _rel(torch.as_tensor(res.velo), ref.velo) <= 1e-9
    assert _rel(torch.as_tensor(res.disp_prev), ref.disp_prev) <= 1e-9
    assert float(ref.disp.abs().max()) > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_a_float32_run_keeps_its_velocities(seed):
    """3,000 float32 steps against the float64 reference: the velocity form
    holds the velocities within 1e-3 of the largest (it reads ~1e-4: the
    element forces' float32 round-off, integrated), where the Fortran's
    displacement form, the reference's own loop in float32, loses them
    past it (~5e-3 here, growing with the deflection)."""
    steps = 3000
    mesh, dbc, loads, fext, bc = _plate(seed)
    res = _run(mesh, dbc, loads, steps, torch.float32)
    ref = _reference_loop(mesh, fext, bc, steps)
    disp_form = _reference_loop(mesh, fext, bc, steps, torch.float32)
    assert _rel(torch.as_tensor(res.velo), ref.velo) <= 1e-3
    assert _rel(torch.as_tensor(res.disp), ref.disp) <= 1e-3
    assert _rel(disp_form.velo.double(), ref.velo) > 1e-3


@pytest.mark.parametrize("dtype, rtol", [
    # one rounding of the half-step velocity at the resume, w from
    # (u^n - u^{n-1}) / dt, which the next 300 steps carry as they carry
    # each step's own round-off: float32 reads 6e-5 of the largest
    # velocity, under the float32 run's bound against float64 above
    (torch.float32, 1e-3),
    (torch.float64, 1e-12),
])
def test_a_resumed_run_takes_its_half_step_velocity_from_the_state(dtype,
                                                                   rtol):
    mesh, dbc, loads, *_ = _plate(0)
    full = _run(mesh, dbc, loads, 600, dtype)
    half = _run(mesh, dbc, loads, 300, dtype)
    rest = _run(mesh, dbc, loads, 300, dtype, init_state=ExplicitState(
        disp=half.disp, disp_prev=half.disp_prev, velo=half.velo, step=300))
    for f in ("disp", "velo", "disp_prev"):
        assert _rel(torch.as_tensor(getattr(rest, f)),
                    torch.as_tensor(getattr(full, f))) <= rtol, f
    clamped = dbc[:, 0].astype(np.int64) * 2 + dbc[:, 1].astype(np.int64)
    assert not rest.disp[clamped].any() and not rest.velo[clamped].any()


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_step_is_the_velocity_form(dtype, seed):
    """One step from a seeded moving state, bit for bit against the velocity
    form written out from the step's pieces: w = (u - u_prev) / dt,
    w_new = w + dt (rhs / M), u_new = u + dt w_new, v = (w + w_new) / 2,
    zero where a dof is clamped (the form kernel B3's node pass keeps)."""
    mesh, dbc, loads, *_ = _plate(seed)
    n_full, n_elem = mesh.n_node * 2, mesh.n_elem
    rng = np.random.default_rng(seed)
    state = 1e-4 * rng.standard_normal((3, n_full))
    state[2] *= 1e4
    res = _run(mesh, dbc, loads, 1, dtype, init_state=ExplicitState(
        disp=state[0], disp_prev=state[1], velo=state[2], step=0))

    as_t = lambda a: torch.as_tensor(a, dtype=dtype)
    u, u_prev, v = (as_t(a) for a in state)
    dest = torch.as_tensor((mesh.conn.T.astype(np.int64)[:, None, :] * 2
                            + np.arange(2)[None, :, None]).reshape(-1))
    seg = Segments.from_dest(dest, n_full + 1)
    coords_em = as_t(to_element_minor(mesh.elem_coords()))
    M = seg.sum(lumped_mass(coords_em, "quad4", DENS, 2, ngp=4))
    fext = torch.zeros(n_full, dtype=dtype)
    fext[torch.as_tensor(loads[:, 0].astype(np.int64) * 2 + 1)] = \
        as_t(loads[:, 2])
    fe = quad_hg_residual(coords_em, u[dest].reshape(8, n_elem),
                          v[dest].reshape(8, n_elem), E, 0.0, DENS,
                          torch.zeros(2, dtype=dtype), thickness=THICK)
    rhs = seg.sum(fe) + fext
    free = torch.ones(n_full, dtype=torch.bool)
    free[torch.as_tensor(dbc[:, 0].astype(np.int64) * 2
                         + dbc[:, 1].astype(np.int64))] = False
    upd = free & (M > 0)
    dt = as_t(DT)
    w = (u - u_prev) / dt
    w_new = torch.where(upd, w + dt * (rhs / torch.where(M > 0, M, 1.0)),
                        0.0)
    new = torch.where(upd, u + dt * w_new, 0.0)
    np.testing.assert_array_equal(res.disp, new.double().numpy())
    np.testing.assert_array_equal(res.velo,
                                  ((w + w_new) * 0.5).double().numpy())
    np.testing.assert_array_equal(res.disp_prev, u.double().numpy())
    assert not res.disp[~free.numpy()].any()
