# Copied from pfemfort_tpu/utils/timing.py (block_on synchronises the tensor's device).
"""Timing/observability helpers (SURVEY §5 'Tracing/profiling' parity).

The reference instruments solves with MPI_Wtime + PetscPrintf milestones
(triapoissonparallelimpl1.F:175,914-921).  `Timer` collects named phase
durations (synchronising the device of `block_on` so the numbers include
the queued kernels), and `timed` is the context-manager form.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict


class Timer:
    """Accumulates named phase timings; `block_on` (a tensor) synchronises
    its device before the phase is closed."""

    def __init__(self):
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None and block_on.device.type == "cuda":
                import torch
                torch.cuda.synchronize(block_on.device)
            self.phases[name] = self.phases.get(name, 0.0) \
                + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.phases.values())
        lines = [f" {k:<24s} {v:9.3f}s" for k, v in self.phases.items()]
        lines.append(f" {'total':<24s} {total:9.3f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def timed(label: str, printer=print):
    """Print `label: X.XXXs` on exit (the reference's 'That took N seconds')."""
    t0 = time.perf_counter()
    yield
    printer(f" {label}: {time.perf_counter() - t0:.3f} seconds")
