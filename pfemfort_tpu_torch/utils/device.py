"""The device rule of the port's public entry points.

Every entry point a user calls (solve_poisson, solve_elasticity,
solve_implicit, solve_implicit_fullsystem, explicit_dynamics,
solve_box_poisson_1e8, fractional_step_ns) runs on the card unless the
caller passes device="cpu"; without a card it raises, it never carries on
on the CPU.  The builders below them take the device from their caller.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device(device); a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r}: torch.cuda.is_available() "
                           "is false (pass device='cpu' to run on the CPU)")
    return device


def synchronize(device: torch.device) -> None:
    """Wait for the queued work of a CUDA device (a no-op on the CPU), so a
    stage's host clock covers its kernels."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
