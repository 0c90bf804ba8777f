"""Number `quad_state_gap`: explicit blocks of the hourglass quad4 program,
state_gap's measure against the plain reference reference/quad_hg.py.  The
reference runs the first block from rest and one later block, drawn from
the seed as state_gap draws it, from the program's own state at its start;
the largest of max|u - u_ref| / max|u_ref| and the same of the velocity
(inf where either is not finite).

Control: the plain reference's own time loop in bfloat16, the precision
below the float32 the mix states: the plate's coordinates at h = 6 mm do
not survive it (its elements fold and the state turns NaN, which the
number reads as inf, or grows without bound on a small plate).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.harness import check, registry
from benchmark.reference import quad_hg

CONTROL = "bfloat16 (the plain reference's time loop)"


def _loop(traffic, p: quad_hg.Problem, state, steps: int, load: dict):
    """`steps` reference steps from `state` (None: at rest) under the run's
    point loads."""
    dev, dt = p.conn.device, p.mass.dtype
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    if state is None:
        z = torch.zeros(p.n_full, dtype=dt, device=dev)
        state = quad_hg.State(z, z.clone(), z.clone())
    else:
        state = quad_hg.State(*(as_t(a) for a in state))
    bc, _ = traffic.physics.dirichlet_dofs(traffic, None, p)
    fext = traffic.physics.load_vector(traffic, load, p)
    return quad_hg.explicit(p, state, steps, traffic.config["explicit"]["dt"],
                            fext, bc)


def value(traffic, units: list) -> float:
    p = check.reference_problem(traffic)
    dev, dt = p.conn.device, p.mass.dtype
    blocks = registry.module("numbers", "state_gap").followed_blocks(
        traffic, len(units))
    load = units[0]["load"]          # the run's loads: the first block's
    gap = 0.0
    for k in blocks:
        unit = units[k]
        start = unit["start"]
        if start is not None:
            start = (start.disp, start.disp_prev, start.velo)
        ref = _loop(traffic, p, start, unit["steps"], load)
        for name, r in (("disp", ref.disp), ("velo", ref.velo)):
            a = torch.as_tensor(np.asarray(unit["answer"][name]), dtype=dt,
                                device=dev)
            g = float((a - r).abs().max() / r.abs().max())
            gap = max(gap, g if math.isfinite(g) else math.inf)
    del p
    return gap


def control(traffic, n_blocks: int, dtype=torch.bfloat16,
            maxiter=None) -> list:
    """n_blocks blocks of the cell's run by the reference's loop in
    `dtype`, each from the last."""
    p = check.reference_problem(traffic, dtype=dtype)
    load = traffic.next_load()
    forces = traffic.physics.force_rows(traffic, load)
    host = lambda t: t.double().cpu().numpy()
    steps = traffic.mix["block_steps"]
    state, start, units = None, None, []
    for _ in range(n_blocks):
        state = _loop(traffic, p, state, steps, load)
        answer = dict(disp=host(state.disp), disp_prev=host(state.disp_prev),
                      velo=host(state.velo))
        units.append(dict(answer=answer, start=start, steps=steps,
                          forces=forces, load=load,
                          converged=bool(np.isfinite(answer["disp"]).all())))
        start = quad_hg.State(*(answer[k]
                                for k in ("disp", "disp_prev", "velo")))
        state = start
    return units
