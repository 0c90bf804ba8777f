"""The yardstick's table of peaks and its count of a kernel's bytes.

HBM_BYTES_PER_S is NVIDIA's data-sheet bandwidth of the H100 SXM (80 GB
HBM3, 3.35 TB/s) at its 700 W limit; a share of it is always stated with the
card's name and power limit beside it (`card()`).
"""

from __future__ import annotations

import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12


def dia_spmv_bytes(nnz: int, n_rows: int, n_offsets: int,
                   itemsize: int) -> int:
    """Bytes one DIA y = A x needs (copied from the port's
    utils/timing.py:spmv_work): each nonzero's value read once, x read once,
    y written once, and the int32 offsets; padding is not counted."""
    return nnz * itemsize + 2 * n_rows * itemsize + 4 * n_offsets


def card() -> dict:
    """The card's name (torch) and power limit (nvidia-smi)."""
    out = dict(name=torch.cuda.get_device_name(0), power_limit=None)
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()[0]
        out["power_limit"] = line.strip()
    except (OSError, subprocess.SubprocessError, IndexError) as ex:
        out["power_limit"] = f"unread ({type(ex).__name__})"
    return out
