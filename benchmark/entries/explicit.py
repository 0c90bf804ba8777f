"""Entry `explicit`: one block of the port's explicit_dynamics
(central differences, lumped mass), resumed from the last block's state
(init_state, start_step).  The configuration's "explicit" gives dt, its
"material" E, nu and rho; the body force is drawn once per run (the first
block's load) and held constant.  The mix gives "dtype" and "block_steps".

Handed to the reference: each block's starting state (None: at rest), its
steps, body force and returned state (disp, disp_prev, velo).  A block
counts as failed when its state is not finite.
"""

import numpy as np
import torch

NUMBER = "state_gap"   # numbers/state_gap.py
RESUMES = True         # a failed block leaves no state to resume from


def run(traffic, load: dict, steps=None) -> dict:
    from pfemfort_tpu_torch import explicit_dynamics
    from pfemfort_tpu_torch.dynamics.checkpoint import ExplicitState
    if traffic.state is None:
        traffic.run_load = load
    cfg = traffic.config
    mat, dt = cfg["material"], cfg["explicit"]["dt"]
    steps = steps or traffic.mix["block_steps"]
    bforce = traffic.physics.bforce(cfg, traffic.run_load)
    b = torch.tensor(bforce, dtype=traffic.dtype, device=traffic.device)
    start = traffic.state
    res = explicit_dynamics(
        traffic.port_mesh(), traffic.dirichlet(load), mat["E"], mat["nu"],
        mat["rho"], dt, steps, bforce_fn=lambda t: b, device=traffic.device,
        dtype=traffic.dtype, init_state=start, start_step=traffic.step)
    traffic.step += steps
    traffic.state = ExplicitState(disp=res.disp, disp_prev=res.disp_prev,
                                  velo=res.velo, step=traffic.step)
    return dict(answer=dict(disp=res.disp, disp_prev=res.disp_prev,
                            velo=res.velo),
                start=start, steps=steps, bforce=bforce,
                converged=bool(np.isfinite(res.disp).all()))
