"""What decides `correct`: the port's answers held against the plain reference.

Run once the window has closed and the program's state is freed.  The
cell's entry names its number (entries/<entry>.py: NUMBER), and
numbers/<number>.py works it out from the window's answers with the plain
reference (benchmark/reference/fem.py), in float64, from the mesh arrays and
loads the benchmark made; it reads the program's answers only to judge
them.  Each number has its limit in benchmark/limits/<cell>.json (PERF.md
gives the readings each limit was set from).

A run is correct when every unit of the window came back with an answer,
none of them failed (an analysis the program reports unconverged, a block
whose state is not finite: `unconverged`, limit 0), and the number is within
its limit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.harness import registry
from benchmark.reference import fem

SAMPLE = 4     # analyses the reference judges in a run


def reference_problem(traffic, dtype=torch.float64) -> fem.Problem:
    """The configuration's problem for the plain reference, on the run's
    device and in `dtype`."""
    m = traffic.mesh_arrays
    coords = torch.as_tensor(m.coords, dtype=dtype, device=traffic.device)
    conn = torch.as_tensor(m.conn, device=traffic.device)
    return traffic.physics.problem(traffic.config, coords, conn)


def analysis_sample(traffic, n: int) -> list:
    """The analyses the reference judges: all of them up to SAMPLE, else
    SAMPLE drawn from the seed."""
    if n <= SAMPLE:
        return list(range(n))
    rng = np.random.default_rng((traffic.seed, 2))
    return sorted(int(i) for i in rng.choice(n, SAMPLE, replace=False))


def number_of(traffic):
    """(name, module) of the number the cell's entry is judged by."""
    name = traffic.entry.NUMBER
    return name, registry.module("numbers", name)


def judge(traffic, units: list, limits: dict) -> dict:
    """{name: {"value", "limit"}} of the cell's compared numbers, and whether
    every unit came back, none failed and the number is within its
    limit."""
    name, number = number_of(traffic)
    answered = [u for u in units if "answer" in u]
    failed = sum(1 for u in units if not u.get("converged", False))
    value = number.value(traffic, answered) if answered else float("inf")
    ok = (bool(answered) and len(answered) == len(units)
          and math.isfinite(value))
    limit = limits[name]
    return dict(correct=ok and failed == 0 and value <= limit,
                numbers={name: dict(value=value, limit=limit),
                         "unconverged": dict(value=failed, limit=0)})
