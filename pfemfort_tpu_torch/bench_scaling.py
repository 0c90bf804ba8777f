# Ported from bench_scaling.py (the JAX package's weak-scaling harness): one torchrun launch per shard count in place of a device mesh.
"""Weak-scaling harness: the sharded CG at fixed work per rank.

    python -m pfemfort_tpu_torch.bench_scaling --per-shard-n 32 \\
        --shards 1 2 4 8 [--rtol 1e-6] [--dtype float32] [--device cuda]

For each shard count S it runs drivers/sharded.py's Poisson solve on
box_tet(0,1,n, 0,1,n, 0,S, S*n) (n = --per-shard-n, so every rank holds an
n^3 slab) at world size S: one `python -m torch.distributed.run` launch
of S rank processes (parallel/multihost.py:torchrun_ranks), NCCL on the
card (one card per rank) or gloo on the CPU.  It prints one JSON line per
S with the JAX harness's keys (shards, elems, iters, solve_s,
spmv_nnz_per_s, weak_scaling_eff, converged; nonzeros estimated as 15 per
free row, as there) and relres, device and rank 0's kernel launches by
kernel.  A shard count with more ranks than the host has cards is skipped
on the card, as the JAX harness skips one above its device count.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _parser():
    p = argparse.ArgumentParser(prog="python -m pfemfort_tpu_torch."
                                "bench_scaling")
    p.add_argument("--per-shard-n", type=int, default=32,
                   help="hex cells per axis per rank (weak scaling: the z "
                        "extent grows with the shard count)")
    p.add_argument("--shards", type=int, nargs="+", default=None,
                   help="shard counts (default 1, 2 and the card count on "
                        "the card; 1 2 4 8 on the CPU)")
    p.add_argument("--rtol", type=float, default=1e-6)
    p.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; NCCL, one card per rank) or cpu "
                        "(gloo)")
    p.add_argument("--out", default=None,
                   help="(a rank's own) file rank 0 writes its result to")
    return p


def _rank(args) -> None:
    """One rank of world size S: the sharded solve; rank 0 writes the
    result to args.out."""
    from pfemfort_tpu_torch.bench import launch_counts
    from pfemfort_tpu_torch.drivers.sharded import solve_implicit_sharded
    from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
    from pfemfort_tpu_torch.mesh import generate
    from pfemfort_tpu_torch.parallel import multihost
    from pfemfort_tpu_torch.sparse import dia_spmv_cuda, ell_spmv_cuda

    multihost.initialize(device=args.device)
    try:
        S, n = multihost.world().size, args.per_shard_n
        mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, S, S * n)
        kernels = {"dia_spmv": dia_spmv_cuda.kernel,
                   "ell_spmv": ell_spmv_cuda.kernel}
        for k in kernels.values():
            k.launches = 0
            k.entry_launches.clear()
        res = solve_implicit_sharded(
            mesh, 1, dbc,
            lambda c: poisson_element_matrices(c, "tetra4", source=-6.0),
            rtol=args.rtol, dtype=DTYPES[args.dtype], device=args.device)
        if multihost.is_coordinator():
            Path(args.out).write_text(json.dumps({
                "shards": S, "elems": int(mesh.n_elem),
                "free_rows": int(mesh.n_node - len(dbc)),
                "iters": int(res.stats.iters),
                "relres": float(res.stats.relres),
                "converged": bool(res.stats.converged),
                "solve_s": float(res.timings["solve_s"]),
                "launches": launch_counts(kernels)}))
    finally:
        multihost.shutdown()


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if "RANK" in os.environ:
        _rank(args)
        return 0
    from pfemfort_tpu_torch.parallel import multihost

    cuda = torch.device(args.device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: torch.cuda.is_available() "
                         "is false (pass --device cpu to run on the CPU)")
    cards = torch.cuda.device_count() if cuda else None
    shards = args.shards or (sorted({1, 2, cards}) if cuda else [1, 2, 4, 8])
    base_rate, rc = None, 0
    with tempfile.TemporaryDirectory(prefix="bench_scaling_") as tmp:
        for S in shards:
            if cuda and S > cards:
                print(f"[bench_scaling] shards {S} skipped: {cards} CUDA "
                      "card(s), one per rank", file=sys.stderr, flush=True)
                continue
            out = Path(tmp) / f"shards{S}.json"
            t0 = time.perf_counter()
            code = multihost.torchrun_ranks(
                ["-m", "pfemfort_tpu_torch.bench_scaling",
                 "--per-shard-n", str(args.per_shard_n), "--rtol",
                 str(args.rtol), "--dtype", args.dtype, "--device",
                 args.device, "--out", str(out)], S)
            if code != 0 or not out.exists():
                print(f"[bench_scaling] shards {S}: the ranks exited {code}",
                      file=sys.stderr, flush=True)
                rc = 1
                continue
            r = json.loads(out.read_text())
            nnz = 15 * r.pop("free_rows")
            rate = nnz * r["iters"] / r["solve_s"]
            if base_rate is None:
                base_rate = rate / S
            rc |= not r["converged"]
            print(json.dumps({
                "shards": S, "elems": r["elems"], "iters": r["iters"],
                "solve_s": r["solve_s"], "spmv_nnz_per_s": rate,
                "weak_scaling_eff": rate / (S * base_rate),
                "converged": r["converged"], "relres": r["relres"],
                "device": args.device, "launches": r["launches"],
                "launch_s": time.perf_counter() - t0}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
