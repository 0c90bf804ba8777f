# Copied from pfemfort_tpu/utils/timing.py (block_on synchronises the tensor's device); the device clock and the SpMV bound below are the port's own.
"""Timing/observability helpers (SURVEY §5 'Tracing/profiling' parity).

The reference instruments solves with MPI_Wtime + PetscPrintf milestones
(triapoissonparallelimpl1.F:175,914-921).  The port's one span facility:

  span(key, into)     a context manager adding its block's host-clock
                      seconds to into[key] (repeated spans of one key add
                      up; into None keeps nothing).  While a torch.profiler
                      runs it also opens record_function("pfem." + key), so
                      the span sits on the profiler's clock beside the
                      device's activity; with no profiler it costs two clock
                      reads and one flag test.  A span never synchronises:
                      a stage span ends where its code synchronises
                      (utils/device.py:synchronize), and device work that a
                      child span queues can land in its parent's self time.
                      A dot in a key names a child of the stage it sits in
                      ("pattern.census_s" inside "pattern_s").
  count(key, n, into) adds n to the counter into[key].
  RECENT              the last 32 Records (name, timings, profiled) that the
                      public drivers appended on returning (`record`), for
                      callers that do not hold the result.
  stage_seconds       the sum of a timings dict's stages (keys ending in _s
                      with no dot: children are inside their stages).

`Timer` collects named phase durations through `span`, synchronising the
device of `block_on` before the phase is closed, and `timed` prints one.

The port adds the card's clock and the SpMV roofline that chip_smoke.py
and the bench harness (bench.py) share: `device_ms` (CUDA events, the
host's cost per call hidden behind a sleep kernel), `spmv_work` and
`spmv_bound` (the least time one y = A x can take at the card's data-sheet
memory and arithmetic rates, `peak_gbps`, `PEAK_FLOPS`), and `library_csr`,
the same matrix for the library's product (cuSPARSE on the card), which
the measurements time beside the kernels and the port never calls.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Deque, Dict, NamedTuple, Optional, Tuple

import torch

from pfemfort_tpu_torch.sparse.dia import DIAMatrix
from pfemfort_tpu_torch.sparse.sliced import unslice

# Data-sheet HBM peaks in GB/s by card name; an unknown card is measured
# against the H100 SXM's.
PEAK_GBPS = {"H100 PCIe": 2000.0, "H100 NVL": 3900.0, "H100": 3350.0}
# Data-sheet peaks of the H100 SXM outside the tensor cores, FLOP/s.
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def profiling() -> bool:
    """Whether a torch.profiler is recording in this process."""
    return torch.autograd._profiler_enabled()


@contextlib.contextmanager
def span(key: str, into: Optional[dict]):
    """Add the block's host-clock seconds to into[key]; under a running
    profiler, also a record_function range "pfem." + key."""
    ctx = (torch.profiler.record_function("pfem." + key) if profiling()
           else contextlib.nullcontext())
    with ctx:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if into is not None:
                into[key] = into.get(key, 0.0) + time.perf_counter() - t0


def count(key: str, n: int, into: dict) -> None:
    """Add n to the counter into[key]."""
    into[key] = into.get(key, 0) + n


def stage_seconds(timings: dict) -> float:
    """Seconds of a driver's stages: its keys ending in _s without a dot."""
    return sum(v for k, v in timings.items()
               if k.endswith("_s") and "." not in k)


class Record(NamedTuple):
    name: str          # the public driver that returned
    timings: dict      # its result's timings
    profiled: bool     # whether a torch.profiler was recording


RECENT: Deque[Record] = collections.deque(maxlen=32)


def record(name: str, timings: dict) -> None:
    """Append a returning driver's timings to RECENT."""
    RECENT.append(Record(name, timings, profiling()))


class Timer:
    """Accumulates named phase timings; `block_on` (a tensor) synchronises
    its device before the phase is closed."""

    def __init__(self):
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        with span(name, self.phases):
            try:
                yield
            finally:
                if block_on is not None and block_on.device.type == "cuda":
                    torch.cuda.synchronize(block_on.device)

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


def peak_gbps(card_name: str) -> float:
    """The data-sheet HBM peak (GB/s) of the card `card_name`
    (torch.cuda.get_device_name)."""
    return next((v for k, v in PEAK_GBPS.items() if k in card_name),
                PEAK_GBPS["H100"])


def device_ms(fn, reps: int = 100, sleep_cycles: int = 200_000_000
              ) -> Tuple[float, bool]:
    """Device ms per call of fn (which queues work on the current CUDA
    stream) with the host's cost per call hidden: a sleep kernel holds the
    stream while the host queues `reps` calls, which then run back to
    back.  Also returns whether the queueing ended before the sleep did
    (else host time leaks into the figure)."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    events[0].record()
    torch.cuda._sleep(sleep_cycles)
    events[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    queued_ms = 1e3 * (time.perf_counter() - t0)
    events[2].record()
    events[2].synchronize()
    slept_ms = events[0].elapsed_time(events[1])
    return events[1].elapsed_time(events[2]) / reps, queued_ms < slept_ms


def spmv_work(A, nnz: int, halo: int = 0) -> Tuple[int, int]:
    """(bytes, flops) that y = A x needs with this matrix's entries: each
    nonzero's value (and, for ELL, its int32 column) read once, x read
    once (with `halo` more entries of a DIA block's neighbours; an ELL
    block's ghost columns are in its n_cols), y written once (DIA: its
    int32 offsets, no column per entry); 2 flops per nonzero.  Padding a
    layout adds (DIA's out-of-band slots, ELL's sentinel slots) is work the
    data does not need, so it is not counted.  A: a DIAMatrix or a
    SlicedELL."""
    size = A.vals.element_size()
    if isinstance(A, DIAMatrix):
        return (nnz * size + (2 * A.n_rows + halo) * size
                + 4 * len(A.offsets), 2 * nnz)
    return nnz * (4 + size) + (A.n_cols + A.n_rows) * size, 2 * nnz


def spmv_bound(A, nnz: int, peak: float, halo: int = 0
               ) -> Tuple[float, str, int]:
    """(bound ms, 'bytes' or 'operations', bytes) of one y = A x at HBM
    peak `peak` GB/s (`spmv_work`)."""
    nbytes, flops = spmv_work(A, nnz, halo)
    t_bytes = nbytes / (peak * 1e9) * 1e3
    t_ops = flops / PEAK_FLOPS[A.vals.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def library_csr(A) -> Tuple[torch.Tensor, int]:
    """torch.sparse_csr_tensor of a DIA (its nonzero in-range entries) or
    sliced ELL (its non-sentinel slots) matrix, int32 indices: its product
    with x is one library SpMV (cuSPARSE on the card).  Returns (csr,
    nnz)."""
    dev = A.vals.device
    if isinstance(A, DIAMatrix):
        N = A.n_rows
        rows = torch.arange(N, device=dev)
        offs = torch.tensor(A.offsets, dtype=torch.int64, device=dev)
        cols = rows[:, None] + offs[None, :]
        vals = A.vals.t()
        keep = (cols >= 0) & (cols < N) & (vals != 0)
        n_cols = N
    else:
        E = unslice(A)
        cols, vals = E.cols.to(torch.int64), E.vals
        keep = cols < A.n_cols
        n_cols = A.n_cols
    counts = keep.sum(1)
    crow = torch.zeros(A.n_rows + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(counts, 0)
    csr = torch.sparse_csr_tensor(crow.to(torch.int32),
                                  cols[keep].to(torch.int32), vals[keep],
                                  size=(A.n_rows, n_cols))
    return csr, int(crow[-1])
