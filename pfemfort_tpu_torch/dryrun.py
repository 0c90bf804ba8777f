# Ported from __graft_entry__.py:dryrun_multichip (its four cases and their assertions).
"""The port's multi-rank dry run: the sharded solve's four routes on tiny
shapes, with the JAX package's assertions.

  halo/dia  box_tet 4x4x(2S), Jacobi: per-rank DIA assembly, the
            halo-exchange CG (kernel B1's halo entry on the card);
  dist/ell  box_tet 5x5x8 renumbered by default_rng(0), recover=False,
            per-rank IC(0): the ghost-exchange ELL route (kernel B2);
  dist_mg   box_tet 4x4x(2S), precond='mg': the distributed geometric
            multigrid (parallel/dist_mg.py);
  dist_amg  box_tet 12x12x16 renumbered by default_rng(5), recover=False,
            precond='amg': the distributed SA-AMG on the ELL route.

Run it as every rank of a group, e.g. on the CPU

    torchrun --standalone --nproc-per-node 4 -m pfemfort_tpu_torch.dryrun \\
        --device cpu

(NCCL with --device cuda, one card per rank).  Without torchrun it runs as
one rank.  Rank 0 prints one line per case; `dryrun` returns
{case: iterations}.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from pfemfort_tpu_torch.drivers.sharded import solve_implicit_sharded
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
from pfemfort_tpu_torch.mesh import generate
from pfemfort_tpu_torch.parallel import multihost


def _poisson(c):
    return poisson_element_matrices(c, "tetra4", source=-6.0)


def _scrambled(n, seed):
    mesh, dbc = generate.box_tet(0, 1, n[0], 0, 1, n[1], 0, 1, n[2])
    perm = np.random.default_rng(seed).permutation(mesh.n_node)
    mesh = mesh.renumbered(perm.astype(np.int64))
    dbc = dbc.copy()
    dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    return mesh, dbc


def _expect(ok: bool, what) -> None:
    """The JAX dry run's `assert`, kept under python -O."""
    if not ok:
        raise AssertionError(what)


def _max_err(mesh, res) -> float:
    return float(np.abs(res.u_full - (mesh.coords ** 2).sum(axis=1)).max())


def dryrun(device="cuda", dtype=torch.float32,
           verbose: bool = True) -> Dict[str, int]:
    """The four cases on every rank of the default process group; asserts
    what the JAX package's dry run asserts.  Returns {case: iterations}."""
    S = multihost.world().size
    say = print if verbose and multihost.is_coordinator() else \
        (lambda *a, **k: None)
    iters = {}

    for dims, label in (((4, 4, 2 * S), "halo/dia"), ((5, 5, 8), "dist/ell")):
        if label == "dist/ell":
            mesh, dbc = _scrambled(dims, 0)
        else:
            mesh, dbc = generate.box_tet(0, 1, dims[0], 0, 1, dims[1],
                                         0, 1, dims[2])
        res = solve_implicit_sharded(
            mesh, 1, dbc, _poisson, dtype=dtype, rtol=1e-6, maxiter=500,
            recover=(label == "halo/dia"),
            precond="jacobi" if label == "halo/dia" else "ic0",
            device=device)
        _expect(res.stats.converged, res.stats)
        _expect(res.timings["distributed_assembly"], res.timings)
        expect = "dia" if label == "halo/dia" else "ell"
        _expect(res.timings["assembly_layout"] == expect, res.timings)
        if label == "dist/ell":
            _expect(res.timings["precond_used"] == "ic0", res.timings)
        err = _max_err(mesh, res)
        _expect(err < 1e-4, err)
        iters[label] = res.stats.iters
        say(f"dryrun({S}) [{label}]: converged in {res.stats.iters} iters, "
            f"max err {err:.2e}, dist_assembly="
            f"{res.timings['distributed_assembly']}")

    mesh, dbc = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 2 * S)
    res = solve_implicit_sharded(mesh, 1, dbc, _poisson, dtype=dtype,
                                 rtol=1e-6, maxiter=60, precond="mg",
                                 device=device)
    _expect(res.timings.get("distributed_mg"), res.timings)
    _expect(res.stats.converged, res.stats)
    err = _max_err(mesh, res)
    _expect(err < 1e-3, err)
    iters["dist_mg"] = res.stats.iters
    say(f"dryrun({S}) [dist_mg]: converged in {res.stats.iters} iters, "
        f"max err {err:.2e}")

    mesh, dbc = _scrambled((12, 12, 16), 5)
    res = solve_implicit_sharded(mesh, 1, dbc, _poisson, dtype=dtype,
                                 rtol=1e-8, maxiter=60, recover=False,
                                 precond="amg", device=device)
    _expect(res.timings["assembly_layout"] == "ell", res.timings)
    _expect(res.timings["precond_used"] == "amg", res.timings)
    _expect(res.stats.converged, res.stats)
    _expect(res.stats.iters <= 30, res.stats.iters)
    err = _max_err(mesh, res)
    _expect(err < 1e-4, err)
    iters["dist_amg"] = res.stats.iters
    say(f"dryrun({S}) [dist_amg]: converged in {res.stats.iters} iters, "
        f"max err {err:.2e}, precond_used={res.timings['precond_used']}")
    return iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pfemfort_tpu_torch.dryrun",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--dtype", choices=["float32", "float64"],
                    default="float32")
    args = ap.parse_args(argv)
    try:
        multihost.initialize(device=args.device)
        dryrun(device=args.device, dtype=getattr(torch, args.dtype))
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
