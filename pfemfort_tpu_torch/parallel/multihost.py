# Ported from pfemfort_tpu/parallel/multihost.py (initialize, is_coordinator; the process group replaces global_mesh).
"""Multi-process bootstrap: one process per rank through torch.distributed.

The reference scales with `mpirun -np N` and PETSc's MPI communicator
(SURVEY §2.6).  Here every rank is one process and every rank calls the
same functions, as MPI ranks do; the process group is the mesh.  The
backend follows the device: NCCL for tensors on the card, gloo on the CPU.

    from pfemfort_tpu_torch.parallel.multihost import initialize, world
    initialize()          # torchrun's environment, or a one-rank group
    w = world()           # rank, size, device (cuda:<local rank>)
    res = solve_implicit_sharded(...)
    if is_coordinator(): write the output
    shutdown()

Ranks come from `torchrun --nproc-per-node N script.py`, or from
`torchrun_ranks`, which re-runs a command that way (the CLI's `--shards N`
uses it).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Optional, Sequence

import torch
import torch.distributed as dist

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}
_PKG_ROOT = str(Path(__file__).resolve().parents[2])


@dataclasses.dataclass(frozen=True)
class World:
    rank: int
    size: int
    device: torch.device


class _State:
    """The temporary directory of a one-rank FileStore, removed at
    shutdown."""
    store_dir: Optional[str] = None


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def _local_size() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def _check_cards(n_local: int) -> None:
    found = torch.cuda.device_count()
    if found < n_local:
        raise RuntimeError(f"{n_local} ranks on this host need {n_local} "
                           f"CUDA cards, found {found}: a rank never shares "
                           "a card")


def initialize(device="cuda") -> None:
    """Set up the default process group (a no-op when one exists): NCCL for
    device 'cuda', gloo for 'cpu'.

    Under torchrun (RANK and WORLD_SIZE set) the group is torchrun's;
    otherwise it is a one-rank group on a FileStore in a temporary directory
    (no TCP port, so concurrent processes never collide).  A NCCL rank first
    takes the card of its local rank."""
    if dist.is_initialized():
        return
    backend = _BACKEND[torch.device(device).type]
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        init_method = "env://"
        rank, world_size = int(os.environ["RANK"]), \
            int(os.environ["WORLD_SIZE"])
    else:
        _State.store_dir = tempfile.mkdtemp(prefix="pfemfort_store_")
        init_method = "file://" + os.path.join(_State.store_dir, "store")
        rank, world_size = 0, 1
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        _check_cards(int(os.environ.get("LOCAL_WORLD_SIZE", world_size)))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    if backend == "nccl":
        # NCCL makes its communicator at the first collective: make it here,
        # so that no solve's clock pays for it
        dist.all_reduce(torch.zeros(1, device=torch.device("cuda", local)))
        torch.cuda.synchronize(local)


def torchrun_ranks(args: Sequence[str], nproc: int,
                   timeout: Optional[float] = None) -> int:
    """Run `python -m torch.distributed.run --standalone --nproc-per-node
    nproc *args` (torchrun binds a free local port itself) with this
    package on the ranks' path, and return its exit code.  `args` is a
    script and its arguments, or `-m module ...`."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_PKG_ROOT, env.get("PYTHONPATH")) if p)
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={nproc}", *args], env=env,
        timeout=timeout).returncode


def world() -> World:
    """This rank, the group's size and the rank's device: cuda:<local rank>
    under NCCL (raising when the host has fewer cards than ranks), the CPU
    under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.multihost."
                           "initialize() first")
    rank, size = dist.get_rank(), dist.get_world_size()
    if dist.get_backend() == "nccl":
        _check_cards(_local_size())
        return World(rank, size, torch.device("cuda", _local_rank()))
    return World(rank, size, torch.device("cpu"))


def is_coordinator() -> bool:
    """Rank 0 (the reference's rank-0 output), or a process without a
    group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def shutdown() -> None:
    """Destroy the process group and remove a one-rank group's store."""
    if dist.is_initialized():
        dist.destroy_process_group()
    if _State.store_dir is not None:
        shutil.rmtree(_State.store_dir, ignore_errors=True)
        _State.store_dir = None
