"""Readings the limits of benchmark/limits/ are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 7 8 9] [--units 2] [--out FILE] \
        [--dtype float64] [--control-dtype float32 --control-maxiter N]

For each seed: the cell's units through the port at the cell's own size
(one analysis, or --units blocks of explicit steps), judged by
harness/check.py; for each control seed, the same number of units from
the control of the cell's number (numbers/<number>.py: `control`).
--dtype runs the program in another precision, --control-dtype the
control (a witness: the plain reference in the program's own precision).
One JSON line per seed: the compared number's value, with no limit
applied.  The lower reading of a limit is the largest program value, the
upper one the smallest control value (PERF.md).  Not run by the
benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--units", type=int, default=1)
    ap.add_argument("--dtype", default=None,
                    help="run the program in this dtype (a witness)")
    ap.add_argument("--control-dtype", default=None,
                    help="run the control in this dtype (a witness)")
    ap.add_argument("--control-maxiter", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import check, registry
    from benchmark.harness.traffic import Traffic

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    with open(ROOT / "BENCHMARK.json") as f:
        cell = registry.Cell(json.load(f), args.workload, ROOT)
    if args.dtype:
        cell.mix = dict(cell.mix, dtype=args.dtype)
    name = registry.module("entries", cell.mix["entry"]).NUMBER
    number = registry.module("numbers", name)
    open_limit = {name: float("inf")}
    ckw, clabel = {}, number.CONTROL
    if args.control_dtype:
        ckw["dtype"] = getattr(torch, args.control_dtype)
        clabel = f"{args.control_dtype} (the control in this precision)"
    if args.control_maxiter:
        ckw["maxiter"] = args.control_maxiter
    out = open(args.out, "a") if args.out else None
    traffic = None

    def emit(**rec):
        line = json.dumps(dict(workload=args.workload, number=name, **rec))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    runs = [("program", s) for s in args.seeds] + \
        [("control", s) for s in args.control_seeds]
    for kind, seed in runs:
        if traffic is None:
            traffic = Traffic(cell.config, cell.mix, seed, "cuda")
        traffic.seed = seed
        traffic.reset()
        t0 = time.perf_counter()
        if kind == "program":
            units = [traffic.run_unit() for _ in range(args.units)]
        else:
            units = number.control(traffic, args.units, **ckw)
        t1 = time.perf_counter()
        torch.cuda.empty_cache()
        v = check.judge(traffic, units, open_limit)["numbers"][name]["value"]
        emit(kind=kind, seed=seed, value=v,
             dtype=cell.mix["dtype"] if kind == "program" else clabel,
             iters=[u.get("iters") for u in units],
             converged=[u.get("converged") for u in units],
             unit_s=t1 - t0, check_s=time.perf_counter() - t1)
        del units
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
