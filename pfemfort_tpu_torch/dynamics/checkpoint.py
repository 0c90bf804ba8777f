# Copied from pfemfort_tpu/dynamics/checkpoint.py.
"""Checkpoint/resume for explicit dynamics (npz state dumps).

The reference writes per-step VTK snapshots but can never read them back
(SURVEY §5 'Checkpoint/resume: none').  Here the integrator state
(u^n, u^{n-1}, v^n, step) round-trips through a single .npz so long runs
survive preemption — table stakes for large-scale production serving.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class ExplicitState(NamedTuple):
    disp: np.ndarray        # u^n
    disp_prev: np.ndarray   # u^{n-1}
    velo: np.ndarray
    step: int


def save_state(path: str, state: ExplicitState) -> None:
    np.savez(path, disp=state.disp, disp_prev=state.disp_prev,
             velo=state.velo, step=np.int64(state.step))


def load_state(path: str) -> ExplicitState:
    with np.load(path) as z:
        return ExplicitState(disp=z["disp"], disp_prev=z["disp_prev"],
                             velo=z["velo"], step=int(z["step"]))
