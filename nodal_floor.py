#!/usr/bin/env python3
"""The float32 nodal-error floor of the box_tet Poisson solve.

    python3 nodal_floor.py [n] [--device cuda|cpu] [--out PATH]

Solves box_tet n (default 200, the bench's `large` stage) with Jacobi-CG
and prints one JSON line per run with its iterations, relres and nodal
error against the exact u = x^2+y^2+z^2:
  * solve_poisson in float32 at rtol 1e-6 (the bench's run), 5e-7 and
    2e-7: a stopping error would shrink with rtol, a round-off floor not;
  * solve_poisson in float64 at rtol 1e-6: the same stopping test without
    float32 round-off;
  * the reduced system assembled from coordinates made on the device
    (mesh.generate.box_tet_coords_em_device, as the JAX bench's stage made
    them) in float32 at rtol 1e-6.
The card's name and power limit come first.  Needs ~25 GB of device memory
at n=200.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from pfemfort_tpu_torch import generate, solve_poisson
from pfemfort_tpu_torch.dofs.dofmap import build_dofmap
from pfemfort_tpu_torch.drivers.common import build_reduced_assembler
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
from pfemfort_tpu_torch.solve.cg import cg_solve, jacobi_preconditioner
from pfemfort_tpu_torch.sparse.ops import operator_and_diag


def _line(out, **row):
    text = json.dumps(row)
    print(text, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(text + "\n")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    n, dev = args.n, torch.device(args.device)
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        _line(args.out, card=card)
    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    u_exact = (mesh.coords ** 2).sum(1)
    for dtype, rtol in ((torch.float32, 1e-6), (torch.float32, 5e-7),
                        (torch.float32, 2e-7), (torch.float64, 1e-6)):
        t0 = time.perf_counter()
        r = solve_poisson(mesh, dbc, device=dev, dtype=dtype, rtol=rtol)
        _line(args.out, run="solve_poisson", n=n, dtype=str(dtype)[6:],
              rtol=rtol, iters=r.stats.iters, relres=r.stats.relres,
              nodal_err=float(np.abs(r.u_full - u_exact).max()),
              seconds=time.perf_counter() - t0)
        del r

    f32 = torch.float32
    dofmap = build_dofmap(mesh, 1, dbc, with_elem=False)
    assemble = build_reduced_assembler(
        mesh, 1, dofmap,
        lambda c: poisson_element_matrices(c, "tetra4", source=-6.0), f32,
        dev)
    A, b = assemble(generate.box_tet_coords_em_device(
        0, 1, n, 0, 1, n, 0, 1, n, dtype=f32, device=dev))
    op, diag = operator_and_diag(A)
    u, st = cg_solve(op, b, precond=jacobi_preconditioner(diag), rtol=1e-6,
                     maxiter=10 * A.n_rows)
    u_red = torch.as_tensor(u_exact[dofmap.assy_for_soln], device=dev)
    _line(args.out, run="device coordinates", n=n, dtype="float32",
          rtol=1e-6, iters=int(st.iters), relres=float(st.relres),
          nodal_err=float((u.double() - u_red).abs().max()))


if __name__ == "__main__":
    main()
