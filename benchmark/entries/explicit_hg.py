"""Entry `explicit_hg`: one block of the port's explicit_dynamics with the
quad4 hourglass residual (use_hourglass, the residual's thickness) under
point loads (force_bc), resumed from the last block's state (init_state,
start_step).  The configuration's "explicit" gives dt, its "material" E,
nu, rho and thick; the loads are drawn once per run (the first block's
load) and held on every step, with no body force, as the reference's
program.  The mix gives "dtype" and "block_steps".

Handed to the reference: each block's starting state (None: at rest), its
steps, the ForceBC rows and the returned state (disp, disp_prev, velo).  A
block counts as failed when its state is not finite.
"""

import numpy as np

NUMBER = "quad_state_gap"   # numbers/quad_state_gap.py
RESUMES = True              # a failed block leaves no state to resume from


def run(traffic, load: dict, steps=None) -> dict:
    from pfemfort_tpu_torch import explicit_dynamics
    from pfemfort_tpu_torch.dynamics.checkpoint import ExplicitState
    if traffic.state is None:
        traffic.run_load = load
    cfg = traffic.config
    mat, dt = cfg["material"], cfg["explicit"]["dt"]
    steps = steps or traffic.mix["block_steps"]
    forces = traffic.physics.force_rows(traffic, traffic.run_load)
    start = traffic.state
    res = explicit_dynamics(
        traffic.port_mesh(), traffic.dirichlet(load), mat["E"], mat["nu"],
        mat["rho"], dt, steps, force_bc=forces, thickness=mat["thick"],
        use_hourglass=True, device=traffic.device, dtype=traffic.dtype,
        init_state=start, start_step=traffic.step)
    traffic.step += steps
    traffic.state = ExplicitState(disp=res.disp, disp_prev=res.disp_prev,
                                  velo=res.velo, step=traffic.step)
    return dict(answer=dict(disp=res.disp, disp_prev=res.disp_prev,
                            velo=res.velo),
                start=start, steps=steps, forces=forces,
                converged=bool(np.isfinite(res.disp).all()))
