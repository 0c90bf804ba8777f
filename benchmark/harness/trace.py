"""The device trace of one unit of work, reduced in memory.

`torch.profiler` (CUPTI on the card) records one whole unit after the
window has closed: an analysis, or a block of explicit steps.  The trace is
never written out; what is kept is

  window_s   the length of the profiled unit (the harness's `unit` span,
             which ends in a device synchronise);
  busy_s     the union of the device's activity intervals (kernels, copies,
             sets) inside it;
  ops        device seconds and launches by operation name;
  gaps       the longest stretches with nothing on the device, each named by
             the host operation that overlapped it most; where that covers
             under half of it, the name says so and leads with host code
             outside torch operations (numpy, Python), which the profiler
             does not see.
"""

from __future__ import annotations

import collections
import time
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

UNIT_SPAN = "unit"
HOST_ONLY = "host code outside torch ops (numpy, Python)"


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    ops: dict                          # name -> device seconds
    launches: dict                     # name -> count
    gaps: List[Tuple[str, float]]      # longest first

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def device_seconds(self, pattern: str) -> Tuple[float, int]:
        """(device seconds, launches) of the operations whose name holds
        `pattern`."""
        names = [n for n in self.ops if pattern in n]
        return (sum(self.ops[n] for n in names),
                sum(self.launches[n] for n in names))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1])[:top]
        return dict(device_ops=[[n[:160], s] for n, s in ops],
                    idle_gaps=[[n[:160], s] for n, s in self.gaps[:top]])


def union(intervals) -> List[Tuple[int, int]]:
    """Merged, sorted [start, end) intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps_of(busy, w0: int, w1: int) -> List[Tuple[int, int]]:
    """The stretches of [w0, w1) that no interval of `busy` (merged)
    covers."""
    out, t = [], w0
    for s, e in busy:
        if s > t:
            out.append((t, min(s, w1)))
        t = max(t, e)
        if t >= w1:
            break
    if t < w1:
        out.append((t, w1))
    return [(s, e) for s, e in out if e > s]


def reduce_events(events, top_gaps: int = 10) -> Trace:
    """A Trace from the profiler's kineto events (each event's methods are
    read once: a block of explicit steps holds ~10^6 of them)."""
    CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    unit, dev, host = None, [], []
    for e in events:
        dur = e.duration_ns()
        if dur <= 0:
            continue
        kind, name, start = e.device_type(), e.name(), e.start_ns()
        if name == UNIT_SPAN:
            if kind == CPU and unit is None:
                unit = (start, start + dur)
        elif kind == CUDA:
            if not e.is_user_annotation():
                dev.append((name, start, start + dur))
        else:
            host.append((name, start, start + dur))
    if unit is None:
        raise RuntimeError("the profiled unit's span is missing")
    w0, w1 = unit
    ops = collections.Counter()
    launches = collections.Counter()
    spans = []
    for name, s0, t0 in dev:
        s, t = max(s0, w0), min(t0, w1)
        if t <= s:
            continue
        ops[name] += (t - s) * 1e-9
        launches[name] += 1
        spans.append((s, t))
    busy = union(spans)
    gaps = sorted(gaps_of(busy, w0, w1), key=lambda g: g[0] - g[1])
    h_start = np.array([h[1] for h in host], dtype=np.int64)
    h_end = np.array([h[2] for h in host], dtype=np.int64)
    named = []
    for g0, g1 in gaps[:top_gaps]:
        best, share = HOST_ONLY, 0.0
        if len(host):
            ov = np.minimum(g1, h_end) - np.maximum(g0, h_start)
            # most overlap first, then the shortest event
            i = int(np.lexsort((h_end - h_start, -ov))[0])
            if ov[i] > 0:
                best, share = host[i][0], ov[i] / (g1 - g0)
        if best != HOST_ONLY and share < 0.5:
            best = f"{HOST_ONLY}; {best} {100 * share:.0f}%"
        named.append((best, (g1 - g0) * 1e-9))
    return Trace(window_s=(w1 - w0) * 1e-9,
                 busy_s=sum(t - s for s, t in busy) * 1e-9,
                 ops=dict(ops), launches=dict(launches), gaps=named)


def profile_unit(fn, device: torch.device):
    """Run fn() once under the profiler; (Trace, seconds the reduction
    took)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        with record_function(UNIT_SPAN):
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    tr = reduce_events(prof.profiler.kineto_results.events())
    return tr, time.perf_counter() - t0
