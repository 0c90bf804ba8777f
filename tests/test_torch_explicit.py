"""Port parity: explicit central-difference dynamics and checkpoint/resume.

`explicit_dynamics` of both packages runs tens of steps on small meshes of
each preset's element (tria3, quad4 with hourglass control, tria6, prism6)
and of tetra4, with a body-force pulse, a nodal load, probes and
snapshots, in float64 on the CPU.  The residuals are summed in the same
order, but the port scatters them with ordered segment sums and the JAX
package with an unsorted segment sum, so round-off differs in the last
bits and grows with the steps: the results must agree to a relative 1e-10.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pfemfort_tpu as ft
from pfemfort_tpu.drivers import presets as P
from pfemfort_tpu.dynamics import checkpoint as jck
from pfemfort_tpu.dynamics.explicit import explicit_dynamics as j_explicit
from pfemfort_tpu_torch import interop
from pfemfort_tpu_torch.dynamics import checkpoint as tck
from pfemfort_tpu_torch.dynamics.explicit import explicit_dynamics

torch.set_num_threads(1)

RTOL = 1e-10
NSTEPS = 30

_CASES = {
    "tria": (lambda: ft.generate.rect_tria(0, 1, 6, 0, 1, 4), P.TRIA_EXPLICIT),
    "quad_hourglass": (lambda: ft.generate.rect_quad(0, 1, 6, 0, 1, 4),
                       P.QUAD_EXPLICIT),
    "tria6": (lambda: ft.generate.rect_tria6(0, 1, 3, 0, 1, 2),
              P.TRIA6_EXPLICIT),
    "prism": (lambda: ft.generate.box_prism(0, 1, 3, 0, 1, 2, 0, 1, 2),
              P.PRISM_EXPLICIT),
    "tetra4": (lambda: ft.generate.box_tet(0, 1, 3, 0, 1, 2, 0, 1, 2)[0],
               P.PRISM_EXPLICIT),
}


def _rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _clamped(mesh):
    nodes = np.nonzero(mesh.coords[:, 0] == mesh.coords[:, 0].min())[0]
    d = mesh.ndim
    return np.stack([np.repeat(nodes, d), np.tile(np.arange(d), len(nodes)),
                     np.zeros(d * len(nodes))], 1).astype(np.float64)


def _setup(name):
    mesh, preset = _CASES[name][0](), _CASES[name][1]
    bforce = preset.bforce if any(preset.bforce) else (1.0,) * mesh.ndim
    pulse = 12 * preset.dt          # the pulse ends inside the run

    def j_bforce(t):
        return jnp.asarray(bforce) * jnp.where(t <= pulse, 1.0, 0.0)

    def t_bforce(t):
        return torch.tensor(bforce, dtype=t.dtype) * torch.where(
            t <= torch.tensor(pulse, dtype=t.dtype), 1.0, 0.0)

    kw = dict(E=preset.E, nu=preset.nu, dens=preset.dens, dt=preset.dt,
              force_bc=np.array([[mesh.n_node - 1, 1, 5.0]]),
              probe_dofs=(2 * mesh.ndim + 1, mesh.n_node * mesh.ndim - 1),
              thickness=preset.thickness, use_hourglass=preset.use_hourglass)
    tmesh = interop.mesh_from_numpy(mesh.etype, mesh.coords, mesh.conn)
    return mesh, tmesh, _clamped(mesh), j_bforce, t_bforce, kw


@pytest.mark.parametrize("name", sorted(_CASES))
def test_explicit_dynamics_matches_jax(name):
    mesh, tmesh, dbc, j_bf, t_bf, kw = _setup(name)
    snaps_j, snaps_t = [], []
    rj = j_explicit(mesh, dbc, nsteps=NSTEPS, bforce_fn=j_bf,
                    snapshot_every=12,
                    snapshot_cb=lambda k, d: snaps_j.append((k, d)), **kw)
    rt = explicit_dynamics(tmesh, dbc, nsteps=NSTEPS, bforce_fn=t_bf,
                           snapshot_every=12,
                           snapshot_cb=lambda k, d: snaps_t.append((k, d)),
                           dtype=torch.float64, **kw, device="cpu")
    for field in ("disp", "velo", "acce", "disp_prev", "probe_history"):
        a, b = getattr(rt, field), getattr(rj, field)
        assert a.shape == b.shape, field
        assert _rel_err(a, b) < RTOL, field
    np.testing.assert_array_equal(rt.times, rj.times)
    assert [k for k, _ in snaps_t] == [k for k, _ in snaps_j] == [12, 24, 30]
    for (_, a), (_, b) in zip(snaps_t, snaps_j):
        assert _rel_err(a, b) < RTOL
    assert np.abs(rt.disp).max() > 0


def test_explicit_dynamics_without_snapshots_or_probes_matches_jax():
    mesh, tmesh, dbc, j_bf, t_bf, kw = _setup("tria")
    kw["probe_dofs"] = ()
    rj = j_explicit(mesh, dbc, nsteps=NSTEPS, bforce_fn=j_bf, **kw)
    rt = explicit_dynamics(tmesh, dbc, nsteps=NSTEPS, bforce_fn=t_bf,
                           dtype=torch.float64, **kw, device="cpu")
    assert rt.probe_history.shape == rj.probe_history.shape == (NSTEPS, 0)
    assert _rel_err(rt.disp, rj.disp) < RTOL
    rt0 = explicit_dynamics(tmesh, dbc, nsteps=NSTEPS, dtype=torch.float64,
                            **kw, device="cpu")
    rj0 = j_explicit(mesh, dbc, nsteps=NSTEPS, **kw)
    assert _rel_err(rt0.disp, rj0.disp) < RTOL


def test_pulse_step_in_float32_falls_where_jax_puts_it():
    """The tria preset's pulse: bforce_x = 1 for t <= 0.1 at dt = 2e-4.
    In float32, k*dt at k = 500 must land on the JAX package's side of
    0.1, and so must every step around it."""
    preset = P.TRIA_EXPLICIT
    mesh = ft.generate.rect_tria(0, 1, 3, 0, 1, 2)
    tmesh = interop.mesh_from_numpy(mesh.etype, mesh.coords, mesh.conn)
    ks = np.arange(490, 511)
    j_on = np.asarray(jnp.arange(490, 511).astype(jnp.float32) * preset.dt
                      <= preset.pulse_t)
    seen = []

    def t_bforce(t):
        on = t <= torch.tensor(preset.pulse_t, dtype=t.dtype)
        seen.append((t.dtype, bool(on)))
        return torch.tensor(preset.bforce, dtype=t.dtype) * torch.where(
            on, 1.0, 0.0)

    explicit_dynamics(tmesh, _clamped(mesh), preset.E, preset.nu,
                      preset.dens, preset.dt, len(ks), bforce_fn=t_bforce,
                      start_step=int(ks[0]), dtype=torch.float32, device="cpu")
    assert all(dt == torch.float32 for dt, _ in seen)
    np.testing.assert_array_equal([on for _, on in seen], j_on)
    assert j_on[ks == 500].item() and not j_on[ks == 501].item()


def test_float32_run_through_the_pulse_matches_jax():
    mesh, tmesh, dbc, _, _, kw = _setup("tria")
    preset = P.TRIA_EXPLICIT
    kw.update(dt=preset.dt)
    j_bf = lambda t: jnp.asarray(preset.bforce, jnp.float32) * jnp.where(
        t <= preset.pulse_t, 1.0, 0.0)
    t_bf = lambda t: torch.tensor(preset.bforce, dtype=t.dtype) * \
        torch.where(t <= torch.tensor(preset.pulse_t, dtype=t.dtype), 1.0,
                    0.0)
    state = jck.ExplicitState(*(np.zeros(mesh.n_node * 2),) * 3, step=495)
    rj = j_explicit(mesh, dbc, nsteps=12, bforce_fn=j_bf, dtype=jnp.float32,
                    init_state=state, **kw)
    rt = explicit_dynamics(tmesh, dbc, nsteps=12, bforce_fn=t_bf,
                           dtype=torch.float32,
                           init_state=tck.ExplicitState(*state), **kw,
                           device="cpu")
    assert rt.probe_history.dtype == np.float32
    assert _rel_err(rt.probe_history, rj.probe_history) < 1e-5
    assert _rel_err(rt.disp, rj.disp) < 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_checkpoint_resume_is_bit_identical(tmp_path, dtype):
    _, tmesh, dbc, _, t_bf, kw = _setup("tria")
    full = explicit_dynamics(tmesh, dbc, nsteps=NSTEPS, bforce_fn=t_bf,
                             dtype=dtype, **kw, device="cpu")
    half = explicit_dynamics(tmesh, dbc, nsteps=NSTEPS // 2, bforce_fn=t_bf,
                             dtype=dtype, **kw, device="cpu")
    path = str(tmp_path / "state.npz")
    tck.save_state(path, tck.ExplicitState(
        disp=half.disp, disp_prev=half.disp_prev, velo=half.velo,
        step=NSTEPS // 2))
    rest = explicit_dynamics(tmesh, dbc, nsteps=NSTEPS - NSTEPS // 2,
                             bforce_fn=t_bf, dtype=dtype,
                             init_state=tck.load_state(path), **kw,
                             device="cpu")
    for field in ("disp", "velo", "acce", "disp_prev"):
        np.testing.assert_array_equal(getattr(rest, field),
                                      getattr(full, field))
    np.testing.assert_array_equal(
        np.concatenate([half.probe_history, rest.probe_history]),
        full.probe_history)
    np.testing.assert_array_equal(np.concatenate([half.times, rest.times]),
                                  full.times)


def test_port_resumes_a_jax_checkpoint(tmp_path):
    """A state saved by the JAX package loads in the port and continues
    its run."""
    mesh, tmesh, dbc, j_bf, t_bf, kw = _setup("quad_hourglass")
    full = j_explicit(mesh, dbc, nsteps=NSTEPS, bforce_fn=j_bf, **kw)
    half = j_explicit(mesh, dbc, nsteps=NSTEPS // 2, bforce_fn=j_bf, **kw)
    path = str(tmp_path / "jax_state.npz")
    jck.save_state(path, jck.ExplicitState(
        disp=half.disp, disp_prev=half.disp_prev, velo=half.velo,
        step=NSTEPS // 2))
    rest = explicit_dynamics(tmesh, dbc, nsteps=NSTEPS - NSTEPS // 2,
                             bforce_fn=t_bf, dtype=torch.float64,
                             init_state=tck.load_state(path), **kw,
                             device="cpu")
    assert _rel_err(rest.disp, full.disp) < RTOL
    assert _rel_err(rest.probe_history, full.probe_history[NSTEPS // 2:]) \
        < RTOL
    st = tck.load_state(path)
    assert st.step == NSTEPS // 2 and isinstance(st, tck.ExplicitState)
