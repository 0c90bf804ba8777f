"""The file of JAX explicit runs that the port's card runs are held to
(tests/explicit_reference.py) is the JAX package's answer, and the port's
CPU run meets it.

Each case is one of the port's element paths on the card: tria3 and tetra4
through kernel B3's element pass, the quad4 hourglass residual through its
torch residual and B3's node pass.  Each runs 40 float64 steps through a
body-force pulse with a nodal load and probes.

    python tests/test_torch_explicit_jax_reference.py   # writes the file
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pfemfort_tpu as ft
from pfemfort_tpu.drivers import presets as P
from pfemfort_tpu.dynamics.explicit import explicit_dynamics as j_explicit

import explicit_reference as ref

torch.set_num_threads(1)

NSTEPS, PULSE_STEPS = 40, 15

_MESHES = {
    "tria": (lambda: ft.generate.rect_tria(0, 2, 24, 0, 1, 10),
             P.TRIA_EXPLICIT),
    "quad_hourglass": (lambda: ft.generate.rect_quad(0, 2, 24, 0, 1, 10),
                       P.QUAD_EXPLICIT),
    "tetra4": (lambda: ft.generate.box_tet(0, 2, 8, 0, 1, 4, 0, 1, 4)[0],
               P.PRISM_EXPLICIT),
}


def _inputs(name):
    mesh, preset = _MESHES[name][0](), _MESHES[name][1]
    nodes = np.nonzero(mesh.coords[:, 0] == mesh.coords[:, 0].min())[0]
    d = mesh.ndim
    dbc = np.stack([np.repeat(nodes, d), np.tile(np.arange(d), len(nodes)),
                    np.zeros(d * len(nodes))], 1).astype(np.float64)
    return dict(
        etype=np.array(mesh.etype), coords=np.asarray(mesh.coords),
        conn=np.asarray(mesh.conn), dirichlet=dbc,
        params=np.array([preset.E, preset.nu, preset.dens, preset.dt,
                         preset.thickness]),
        use_hourglass=np.array(preset.use_hourglass),
        bforce=np.array(preset.bforce if any(preset.bforce) else (1.0,) * d,
                        dtype=np.float64),
        pulse=np.array(PULSE_STEPS * preset.dt),
        force_bc=np.array([[mesh.n_node - 1, 1, 5.0]]),
        probe_dofs=np.array([d + 1, mesh.n_node * d - 1]),
        nsteps=np.array(NSTEPS))


def _jax_run(case):
    E, nu, dens, dt, thickness = case["params"]
    mesh = ft.Mesh(etype=str(case["etype"]), coords=case["coords"],
                   conn=case["conn"])
    b, pulse = jnp.asarray(case["bforce"]), float(case["pulse"])
    r = j_explicit(
        mesh, case["dirichlet"], E=E, nu=nu, dens=dens, dt=dt,
        nsteps=int(case["nsteps"]),
        bforce_fn=lambda t: b * jnp.where(t <= pulse, 1.0, 0.0),
        force_bc=case["force_bc"],
        probe_dofs=tuple(int(d) for d in case["probe_dofs"]),
        thickness=thickness, use_hourglass=bool(case["use_hourglass"]))
    return {f: np.asarray(getattr(r, f), dtype=np.float64)
            for f in ref.FIELDS}


def write():
    """Run each case through the JAX package and write the file."""
    arrays = {}
    for name in ref.NAMES:
        case = _inputs(name)
        case.update(_jax_run(case))
        arrays.update({f"{name}/{k}": v for k, v in case.items()})
    ref.FILE.parent.mkdir(exist_ok=True)
    np.savez_compressed(ref.FILE, **arrays)


@pytest.mark.parametrize("name", ref.NAMES)
def test_the_reference_file_is_the_jax_packages_run(name):
    case = ref.load(name)
    fresh = _inputs(name)
    for k, v in fresh.items():
        np.testing.assert_array_equal(case[k], v, err_msg=k)
    again = _jax_run(case)
    for f in ref.FIELDS:
        assert case[f].shape == again[f].shape, f
        assert ref.rel_err(case[f], again[f]) <= 1e-12, f
    assert np.abs(case["disp"]).max() > 0


@pytest.mark.parametrize("name", ref.NAMES)
def test_the_ports_cpu_run_meets_the_reference_file(name):
    case = ref.load(name)
    r = ref.run_port(case, "cpu")
    for f in ref.FIELDS:
        assert ref.rel_err(getattr(r, f), case[f]) < ref.RTOL, f


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)    # as tests/conftest.py
    write()
