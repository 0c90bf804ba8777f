"""The port's multi-rank dry run (pfemfort_tpu_torch/dryrun.py) against the
JAX package's __graft_entry__.py:dryrun_multichip.

`python -m pfemfort_tpu_torch.dryrun --device cpu --dtype float64` runs as
2 and 4 gloo ranks under torchrun: every case's assertions hold (the run
exits 0), rank 0 alone prints one line per case, and each case's
iteration count equals the JAX dry run's at the same device count (float64
in this process).  Besides: the new modules of the distributed slice
import neither JAX nor the JAX package, and their entry points default to
the card and raise without one.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pfemfort_tpu_torch.parallel import multihost

REPO = Path(__file__).resolve().parents[1]
CASES = ("halo/dia", "dist/ell", "dist_mg", "dist_amg")
NEW_MODULES = ("pfemfort_tpu_torch.dryrun",
               "pfemfort_tpu_torch.parallel.dist_partition",
               "pfemfort_tpu_torch.parallel.dist_mg",
               "pfemfort_tpu_torch.dynamics.sharded",
               "pfemfort_tpu_torch.solve.amg",
               "pfemfort_tpu_torch.drivers.sharded",
               "pfemfort_tpu_torch.interop")


def _counts(out, prefix):
    found = {}
    for label in CASES:
        m = re.findall(rf"{prefix}\(\d+\) \[{re.escape(label)}\]: converged "
                       rf"in (\d+) iters", out)
        assert len(m) == 1, (label, out)
        found[label] = int(m[0])
    return found


@pytest.mark.parametrize("size", (2, 4))
def test_dryrun_matches_the_jax_dry_run(capfd, size):
    sys.path.insert(0, str(REPO))
    try:
        from __graft_entry__ import dryrun_multichip
    finally:
        sys.path.remove(str(REPO))
    rc = multihost.torchrun_ranks(
        ["-m", "pfemfort_tpu_torch.dryrun", "--device", "cpu", "--dtype",
         "float64"], size, timeout=300)
    out_t = capfd.readouterr().out
    assert rc == 0, out_t
    dryrun_multichip(size)
    out_j = capfd.readouterr().out
    assert _counts(out_t, "dryrun") == _counts(out_j, "dryrun_multichip")


def test_new_modules_import_no_jax():
    code = ("import sys; import " + ", ".join(NEW_MODULES) + "; "
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'pfemfort_tpu.')) or "
            "m == 'pfemfort_tpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "[]"
    for path in [REPO / (m.replace(".", "/") + ".py") for m in NEW_MODULES] \
            + [REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in ("jax", "pfemfort_tpu"), \
                    f"{path}: {line}"


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_new_entry_points_default_to_the_card():
    from pfemfort_tpu_torch.dryrun import main
    from pfemfort_tpu_torch.dynamics.sharded import explicit_dynamics_sharded
    from pfemfort_tpu_torch.mesh import generate
    from pfemfort_tpu_torch.parallel.dist_mg import solve_sharded_mg
    from pfemfort_tpu_torch.parallel.dist_partition import \
        rcb_partition_device

    mesh, dbc = generate.box_tet(0, 1, 2, 0, 1, 2, 0, 1, 2)
    calls = (lambda: solve_sharded_mg(mesh, 1, dbc, None),
             lambda: explicit_dynamics_sharded(mesh, dbc, 1.0, 0.3, 1.0,
                                               1e-3, 1),
             lambda: rcb_partition_device(np.zeros((4, 3)), 2),
             lambda: main([]))
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA|cuda"):
            call()
