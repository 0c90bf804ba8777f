"""The JAX package's explicit runs that the port's card runs are held to.

`tests/data/explicit_jax_reference.npz` holds, for each case, the inputs
of a float64 `explicit_dynamics` run (mesh, Dirichlet rows, material, dt,
a body-force pulse, a nodal load, probes) and what the JAX package's
`explicit_dynamics` returned for them on the CPU.  The card has no JAX, so
its tests compare with this file; `tests/test_torch_explicit_jax_reference.py`
holds the file to the JAX package and writes it anew:

    python tests/test_torch_explicit_jax_reference.py

This module imports no JAX.
"""

from pathlib import Path

import numpy as np
import torch

from pfemfort_tpu_torch import interop
from pfemfort_tpu_torch.dynamics.explicit import explicit_dynamics

FILE = Path(__file__).resolve().parent / "data" / "explicit_jax_reference.npz"
NAMES = ("quad_hourglass", "tetra4", "tria")
FIELDS = ("disp", "velo", "acce", "disp_prev", "probe_history")
RTOL = 1e-10     # tests/test_torch_explicit.py's: the sums' round-off


def load(name: str) -> dict:
    """One case of the file: its inputs and the JAX package's results."""
    with np.load(FILE) as f:
        return {k.split("/", 1)[1]: f[k] for k in f.files
                if k.startswith(name + "/")}


def bforce_fn(case: dict, dtype: torch.dtype, device):
    """The case's body force: `bforce` while t <= `pulse`, then zero."""
    b = torch.tensor(case["bforce"], dtype=dtype, device=device)
    pulse = torch.tensor(float(case["pulse"]), dtype=dtype, device=device)
    return lambda t: b * torch.where(t <= pulse, 1.0, 0.0)


def run_port(case: dict, device, dtype=torch.float64):
    """The port's `explicit_dynamics` on the case's inputs."""
    E, nu, dens, dt, thickness = case["params"]
    mesh = interop.mesh_from_numpy(str(case["etype"]), case["coords"],
                                   case["conn"])
    return explicit_dynamics(
        mesh, case["dirichlet"], E, nu, dens, dt, int(case["nsteps"]),
        bforce_fn=bforce_fn(case, dtype, device), force_bc=case["force_bc"],
        probe_dofs=tuple(int(d) for d in case["probe_dofs"]),
        thickness=thickness, use_hourglass=bool(case["use_hourglass"]),
        device=device, dtype=dtype)


def rel_err(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
