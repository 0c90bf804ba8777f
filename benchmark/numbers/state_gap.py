"""Number `state_gap`: explicit blocks.  The plain reference runs the first
block from rest and one later block, drawn from the seed, from the
program's own state at its start (it can only follow the program there;
the first block checks the start alone); the largest of
max|u - u_ref| / max|u_ref| and the same of the velocity.

Control: the plain reference's own time loop in bfloat16, the precision
below the float32 the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import check
from benchmark.reference import fem

CONTROL = "bfloat16 (the plain reference's time loop)"


def followed_blocks(traffic, n_blocks: int) -> list:
    """The blocks the reference follows: the first, and one later block
    drawn from the seed."""
    if n_blocks < 2:
        return [0]
    rng = np.random.default_rng((traffic.seed, 1))
    return [0, int(rng.integers(1, n_blocks))]


def _loop(traffic, p: fem.Problem, state, steps: int, bforce):
    """`steps` reference steps from `state` (None: at rest)."""
    dev, dt = p.conn.device, p.geom.vol.dtype
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    if state is None:
        z = torch.zeros(p.n_full, dtype=dt, device=dev)
        state = fem.State(z, z.clone(), z.clone())
    else:
        state = fem.State(*(as_t(a) for a in state))
    bc, _ = traffic.physics.dirichlet_dofs(traffic, None, p)
    cfg = traffic.config
    return fem.explicit(p, state, steps, cfg["explicit"]["dt"],
                        cfg["material"]["rho"], as_t(bforce), bc)


def value(traffic, units: list) -> float:
    p = check.reference_problem(traffic)
    dev, dt = p.conn.device, p.geom.vol.dtype
    gap = 0.0
    for k in followed_blocks(traffic, len(units)):
        unit = units[k]
        start = unit["start"]
        if start is not None:
            start = (start.disp, start.disp_prev, start.velo)
        ref = _loop(traffic, p, start, unit["steps"], unit["bforce"])
        for name, r in (("disp", ref.disp), ("velo", ref.velo)):
            a = torch.as_tensor(np.asarray(unit["answer"][name]), dtype=dt,
                                device=dev)
            gap = max(gap, float((a - r).abs().max() / r.abs().max()))
    del p
    return gap


def control(traffic, n_blocks: int, dtype=torch.bfloat16,
            maxiter=None) -> list:
    """n_blocks blocks of the cell's run by the reference's loop in
    `dtype`, each from the last."""
    p = check.reference_problem(traffic, dtype=dtype)
    load = traffic.next_load()
    bforce = traffic.physics.bforce(traffic.config, load)
    host = lambda t: t.double().cpu().numpy()
    steps = traffic.mix["block_steps"]
    state, start, units = None, None, []
    for _ in range(n_blocks):
        state = _loop(traffic, p, state, steps, bforce)
        answer = dict(disp=host(state.disp), disp_prev=host(state.disp_prev),
                      velo=host(state.velo))
        units.append(dict(answer=answer, start=start, steps=steps,
                          bforce=bforce, load=load,
                          converged=bool(np.isfinite(answer["disp"]).all())))
        start = fem.State(*(answer[k] for k in ("disp", "disp_prev", "velo")))
        state = start
    return units
