"""One run of one cell of the benchmark of pfemfort_tpu_torch on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Set-up makes the cell's mesh arrays and loads
from the seed and builds every kernel with one unit of work on a small mesh
of the same kind, physics and precision; the window then runs whole units
(analyses, or blocks of explicit steps) until the one that crosses
--seconds has ended.  With --trace 0 the last line of standard
output holds the cell's end-to-end metrics; with --trace 1 one more unit
runs under the profiler after the window, and the line holds the per-layer
metrics.  Then the plain reference judges the window's answers
(harness/check.py).  Without a card, or with fewer cards than the cell
asks for, the run exits 2 and prints no result; if jax, jaxlib, flax or
the JAX package are loaded once the window has closed, it exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "pfemfort_tpu"}
CACHE = ROOT / ".bench_cache"
# the program's own stage timings, printed per unit beside the metrics
STAGES = ("pattern_s", "assemble_s", "host_assemble_s", "mg_setup_s",
          "solve_s")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is jax, jaxlib, flax or the JAX package."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


class RunRecord:
    """What the metric readers (benchmark/metrics/*.py) read."""

    def __init__(self, traffic, units, window_s, peak_bytes, setup_s, trace):
        self.traffic, self.units, self.trace = traffic, units, trace
        self.window_s, self.peak_bytes, self.setup_s = (window_s, peak_bytes,
                                                        setup_s)

    @property
    def timed(self):
        """The window's units that ran to an answer with the program's
        timings."""
        return [u for u in self.units if "timings" in u]


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device="cuda", config_patch=None, mix_patch=None) -> dict:
    """One run; returns the result line's object (its last key `checks`).
    config_patch and mix_patch replace top-level keys of the cell's files
    (the tests' tiny boxes)."""
    import torch

    from benchmark.harness import check, peaks, registry
    from benchmark.harness.trace import profile_unit
    from benchmark.harness.traffic import Traffic

    cell = registry.Cell(bench, name, ROOT)
    config = dict(cell.config, **(config_patch or {}))
    cell.mix = dict(cell.mix, **(mix_patch or {}))
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)

    traffic = Traffic(config, cell.mix, seed, device)
    traffic.warm().run_unit(steps=cell.mix.get("warm_steps"))
    sync()
    setup_s = time.perf_counter() - T_START
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    units = []
    w0 = time.perf_counter()
    while True:
        try:
            units.append(traffic.run_unit())
        except Exception as ex:  # a failed unit is counted, the run goes on
            traceback.print_exc(file=sys.stderr)
            units.append(dict(error=repr(ex)))
            if traffic.entry.RESUMES:
                break           # no state to resume from
        if time.perf_counter() - w0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    tr = None
    if trace:
        tr, reduce_s = profile_unit(traffic.run_unit, device)
        print(f"trace: reduced in {reduce_s:.3f} s", file=sys.stderr)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    verdict = check.judge(traffic, units, cell.limits)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    record = RunRecord(traffic, units, window_s, peak, setup_s, tr)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = registry.module("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = dict(value=float(value), unit=m["unit"])

    out = dict(correct=bool(verdict["correct"]), attempted=len(units),
               failed=verdict["numbers"]["unconverged"]["value"],
               metrics=metrics)
    if cuda:
        card = peaks.card()
        out["device"] = dict(platform="gpu", kind=card["name"],
                             count=int(cell.workload["chips"]),
                             memory_peak_bytes=int(peak))
        out["card"] = card
    else:
        out["device"] = dict(platform="cpu", kind="cpu", count=1,
                             memory_peak_bytes=0)
    if tr is not None:
        out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = tr.breakdown()
    out["window"] = dict(
        seconds=window_s, units=len(units),
        steps=sum(u.get("steps", 0) for u in units),
        iters=[u.get("iters") for u in units],
        unit_s=[u.get("seconds") for u in units],
        stages={k: [u["timings"].get(k) for u in record.timed]
                for k in STAGES})
    out["checks"] = verdict["numbers"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the run lives at a fixed path inside the checkout (the
    # port builds its kernels into pfemfort_tpu_torch/_build/ there itself)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    chips = [w for w in bench["workloads"]
             if w["name"] == args.workload][0]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    card = out.get("card", {})
    print(f"card: {card.get('name')} power limit {card.get('power_limit')}",
          file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
