"""Port parity: the weak-scaling harness (pfemfort_tpu_torch/bench_scaling.py)
on 1, 2, 4 and 8 gloo ranks.

The harness runs as a fresh process that never imports JAX, launching one
torchrun group per shard count; on box_tet(0,1,6, 0,1,6, 0,S, 6S) in
float64 its iteration counts must equal the JAX package's
solve_implicit_sharded on S virtual devices (the JAX harness's solve,
bench_scaling.py, in float64; SCALING_virtual8.json's counts are JAX's
float32 ones, which may differ).  Each line carries the JAX harness's keys.
"""

import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
SHARDS = (1, 2, 4, 8)
N = 6
JAX_KEYS = {"shards", "elems", "iters", "solve_s", "spmv_nnz_per_s",
            "weak_scaling_eff", "converged"}


@pytest.fixture(scope="module")
def lines():
    proc = subprocess.run(
        [sys.executable, "-m", "pfemfort_tpu_torch.bench_scaling",
         "--per-shard-n", str(N), "--shards", *map(str, SHARDS), "--device",
         "cpu", "--dtype", "float64"], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = [json.loads(line) for line in proc.stdout.splitlines()
           if line.startswith("{")]
    return {r["shards"]: r for r in out}


@functools.lru_cache(maxsize=None)
def _jax_iters(S):
    import jax
    import jax.numpy as jnp
    from pfemfort_tpu.drivers.sharded import solve_implicit_sharded
    from pfemfort_tpu.elements.poisson import poisson_element_matrices
    from pfemfort_tpu.mesh import generate

    mesh, dbc = generate.box_tet(0, 1, N, 0, 1, N, 0, S, S * N)
    dm = jax.sharding.Mesh(np.array(jax.devices()[:S]), ("shard",))
    res = solve_implicit_sharded(
        mesh, 1, dbc,
        lambda c: poisson_element_matrices(c, "tetra4", source=-6.0),
        device_mesh=dm, rtol=1e-6, dtype=jnp.float64)
    return int(np.asarray(res.stats.iters)), int(mesh.n_elem)


@pytest.mark.parametrize("S", SHARDS)
def test_counts_equal_jax_solve_implicit_sharded(lines, S):
    r = lines[S]
    iters, elems = _jax_iters(S)
    assert r["iters"] == iters and r["elems"] == elems
    assert r["converged"] and r["relres"] <= 1e-6


def test_lines_carry_the_jax_harness_keys(lines):
    assert sorted(lines) == list(SHARDS)
    for S, r in lines.items():
        assert JAX_KEYS <= set(r)
        assert r["solve_s"] > 0 and r["spmv_nnz_per_s"] > 0
    assert lines[1]["weak_scaling_eff"] == 1.0
