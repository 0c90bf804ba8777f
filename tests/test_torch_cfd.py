"""Port parity: the incompressible Navier-Stokes fractional-step solver
(cfd/navierstokes.py).

20 steps of the 12x12 lid-driven cavity and of the 8^3 box with a
non-solenoidal start, float64 on the CPU: velocity, pressure and the
per-step max |div u| within 1e-7 of the JAX package (relative to each
field's max).  Then the JAX package's four physical tests
(tests/test_cfd.py there) run on the port, with their bars unchanged.
"""

import numpy as np
import pytest
import torch

from pfemfort_tpu.cfd.navierstokes import fractional_step_ns as j_ns
from pfemfort_tpu.mesh import generate as jgen
from pfemfort_tpu_torch.cfd import fractional_step_ns
from pfemfort_tpu_torch.mesh import generate

torch.set_num_threads(2)
REL = 1e-7


def ns(mesh, bcs, **kw):
    return fractional_step_ns(mesh, bcs, dtype=torch.float64, device="cpu",
                              **kw)


def _cavity_bcs(mesh, lid_u=1.0):
    x, y = mesh.coords[:, 0], mesh.coords[:, 1]
    top = np.isclose(y, 1.0)
    wall = np.isclose(y, 0.0) | np.isclose(x, 0.0) | np.isclose(x, 1.0)
    rows = []
    for nid in np.nonzero(top)[0]:
        rows.append([nid, 0, lid_u if not (np.isclose(x[nid], 0)
                                           or np.isclose(x[nid], 1)) else 0.0])
        rows.append([nid, 1, 0.0])
    for nid in np.nonzero(wall & ~top)[0]:
        rows.append([nid, 0, 0.0])
        rows.append([nid, 1, 0.0])
    return np.asarray(rows, dtype=np.float64)


def _free_slip_box_bcs(mesh):
    """Fix the NORMAL velocity component to 0 on every box face."""
    X = mesh.coords
    rows = []
    for d in range(mesh.ndim):
        for val in (X[:, d].min(), X[:, d].max()):
            for nid in np.nonzero(np.isclose(X[:, d], val))[0]:
                rows.append([nid, d, 0.0])
    return np.asarray(rows, dtype=np.float64)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() \
        / max(np.abs(np.asarray(b)).max(), 1e-300)


@pytest.mark.parametrize("case", ["cavity", "box"])
def test_twenty_steps_match_jax(case):
    if case == "cavity":
        jm = jgen.rect_tria(0, 1, 12, 0, 1, 12)
        tm = generate.rect_tria(0, 1, 12, 0, 1, 12)
        bcs = _cavity_bcs(jm)
        kw = dict(nu_visc=0.05, dt=2e-3, nsteps=20)
    else:
        jm = jgen.box_tet(0, 1, 8, 0, 1, 8, 0, 1, 8)[0]
        tm = generate.box_tet(0, 1, 8, 0, 1, 8, 0, 1, 8)[0]
        bcs = _free_slip_box_bcs(jm)
        x, y, z = jm.coords.T
        kw = dict(nu_visc=0.05, dt=1e-3, nsteps=20,
                  u0=np.stack([np.sin(x), np.sin(y), np.sin(z)], axis=1))
    rj = j_ns(jm, bcs, **kw)
    rt = ns(tm, bcs, **kw)
    assert rt.velocity.shape == rj.velocity.shape
    assert _rel(rt.velocity, rj.velocity) < REL
    assert _rel(rt.pressure, rj.pressure) < REL
    assert _rel(rt.div_history, rj.div_history) < REL
    np.testing.assert_array_equal(rt.times, rj.times)
    assert rt.cg_iters.shape == (20,) and (rt.cg_iters > 0).all()


def test_lid_driven_cavity_stable_and_sensible():
    mesh = generate.rect_tria(0, 1, 12, 0, 1, 12)
    bcs = _cavity_bcs(mesh)
    res = ns(mesh, bcs, nu_visc=0.05, dt=2e-3, nsteps=300)
    assert np.isfinite(res.velocity).all()
    assert np.isfinite(res.pressure).all()
    speed = np.linalg.norm(res.velocity, axis=1)
    assert speed.max() <= 1.5
    interior = ~(np.isclose(mesh.coords[:, 0], 0)
                 | np.isclose(mesh.coords[:, 0], 1)
                 | np.isclose(mesh.coords[:, 1], 0)
                 | np.isclose(mesh.coords[:, 1], 1))
    assert speed[interior].max() > 0.05
    assert res.velocity[interior, 0].min() < -0.01
    assert res.div_history[-1] <= 1.5 * res.div_history[0] + 1e-8


def test_taylor_green_decay():
    npts = 16
    mesh = generate.rect_tria(0, np.pi, npts, 0, np.pi, npts)
    x, y = mesh.coords[:, 0], mesh.coords[:, 1]
    u0 = np.stack([np.sin(x) * np.cos(y), -np.cos(x) * np.sin(y)], axis=1)
    bd = generate.boundary_nodes(mesh)
    bcs = np.asarray([[nid, c, u0[nid, c]] for nid in bd for c in (0, 1)],
                     dtype=np.float64)
    res = ns(mesh, bcs, nu_visc=0.05, dt=2e-3, nsteps=200, u0=u0)
    assert np.isfinite(res.velocity).all()
    e0 = (u0 ** 2).sum()
    e1 = (res.velocity ** 2).sum()
    assert 0.2 * e0 < e1 < e0


def test_taylor_green_3d_decay_rate():
    npts = 10
    mesh, _ = generate.box_tet(0, np.pi, npts, 0, np.pi, npts,
                               0, np.pi / 2, npts // 2)
    x, y = mesh.coords[:, 0], mesh.coords[:, 1]
    u0 = np.stack([np.sin(x) * np.cos(y), -np.cos(x) * np.sin(y),
                   np.zeros_like(x)], axis=1)
    nu, dt, nsteps = 0.05, 2e-3, 250
    res = ns(mesh, _free_slip_box_bcs(mesh), nu_visc=nu, dt=dt,
             nsteps=nsteps, u0=u0)
    assert np.isfinite(res.velocity).all()
    ratio = (res.velocity ** 2).sum() / (u0 ** 2).sum()
    expect = np.exp(-4 * nu * nsteps * dt)
    assert 0.7 * expect < ratio < 1.3 * expect, (ratio, expect)
    assert np.abs(res.velocity[:, 2]).max() < 0.05


def test_projection_divergence_decays_with_rate():
    npts = 8
    mesh, _ = generate.box_tet(0, 1, npts, 0, 1, npts, 0, 1, npts)
    x, y, z = mesh.coords.T
    u0 = np.stack([np.sin(x), np.sin(y), np.sin(z)], axis=1)
    res = ns(mesh, _free_slip_box_bcs(mesh), nu_visc=0.05, dt=1e-3,
             nsteps=20, u0=u0)
    d = res.div_history
    assert np.isfinite(d).all()
    assert d[-1] < 0.35 * np.abs(np.cos(x) + np.cos(y) + np.cos(z)).max()
    assert d[-1] <= 1.2 * d[0]


def test_without_a_card_the_default_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mesh = generate.rect_tria(0, 1, 4, 0, 1, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        fractional_step_ns(mesh, _cavity_bcs(mesh), nu_visc=0.05, dt=2e-3,
                           nsteps=1)
