"""b1_roofline: kernel B1 (the DIA SpMV, csrc/dia_spmv.cu) as a share of its
roofline in the traced analysis: the least time of one product, the bytes
it needs at the cell's one fine-system shape (harness/peaks.py, nonzeros
counted by the plain reference) over the H100's data-sheet 3.35 TB/s,
divided by B1's mean device time a launch in the trace.  The card's power
limit is printed beside it.  The byte count is fixed by the configuration
and the precision, so it is worked out once per checkout and kept in
.bench_cache/b1_bytes/."""

import hashlib
import json
from pathlib import Path

from benchmark.harness import check, peaks
from benchmark.reference import fem

UNIT, LAYER, MOVES, SOURCE = "%", "kernels", "analysis_s", "device_trace"
CACHE = Path(__file__).resolve().parents[2] / ".bench_cache" / "b1_bytes"


def b1_bytes(traffic, load) -> int:
    cfg = traffic.config
    key = json.dumps([cfg["physics"], cfg["mesh"], cfg["dirichlet"],
                      cfg["material"], str(traffic.dtype)], sort_keys=True)
    path = CACHE / (hashlib.sha256(key.encode()).hexdigest()[:24] + ".json")
    if path.is_file():
        return json.loads(path.read_text())["bytes"]
    p = check.reference_problem(traffic)
    bc, _ = traffic.physics.dirichlet_dofs(traffic, load, p)
    n, nnz, n_off = fem.reduced_nonzeros(p, bc)
    del p
    nbytes = peaks.dia_spmv_bytes(nnz, n, n_off, traffic.dtype.itemsize)
    CACHE.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(dict(key=key, rows=n, nonzeros=nnz,
                                    offsets=n_off, bytes=nbytes)))
    return nbytes


def read(run):
    if run.trace is None or not run.timed:
        return None
    seconds, launches = run.trace.device_seconds("dia_spmv")
    if not launches:
        return None
    least = b1_bytes(run.traffic, run.timed[0]["load"]) / peaks.HBM_BYTES_PER_S
    return 100.0 * least / (seconds / launches)
