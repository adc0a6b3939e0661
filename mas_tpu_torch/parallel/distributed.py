"""Process bootstrap, as ``mas_tpu/parallel/distributed.py``.

``initialize`` reads the launcher's environment (``torchrun`` sets
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``) before it touches a device, and joins
the process group.  Without that environment it is a no-op: one process,
no process group, and every collective of ``collectives`` is the
identity.

Each rank runs on one device: ``cuda:LOCAL_RANK % device_count`` for a
CUDA device type, the CPU otherwise.  The backend follows where the ranks
live: NCCL when every local rank has a card of its own, gloo when local
ranks share a card (NCCL refuses two ranks on one device) or run on the
CPU.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

LAUNCH_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR")


def launched() -> bool:
    """True when a launcher set the environment of a process group."""
    return all(k in os.environ for k in LAUNCH_ENV)


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(device_type: str) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK % device_count`` under a
    launcher, ``device_type`` as given otherwise."""
    dev = torch.device(device_type)
    if not launched() or dev.type != "cuda":
        return dev
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("a CUDA device was asked for and there is none")
    return torch.device("cuda", int(os.environ["LOCAL_RANK"]) % n)


def backend_for(device: torch.device) -> str:
    """NCCL when each local rank has a card of its own, else gloo."""
    if device.type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def initialize(device_type: str = "cuda") -> dict:
    """Join the process group when launched (once; a repeat call is a
    no-op) and return the topology: the JAX keys ``process_index``,
    ``process_count``, ``local_devices``, ``global_devices`` and
    ``backend`` (the process group's, None for one process), and
    ``device``, this rank's device."""
    device = rank_device(device_type)
    if launched() and not dist.is_initialized():
        backend = backend_for(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]),
            device_id=device if backend == "nccl" else None)
    backend: Optional[str] = (dist.get_backend() if dist.is_initialized()
                              else None)
    return dict(process_index=rank(), process_count=world_size(),
                local_devices=1, global_devices=world_size(),
                backend=backend, device=device)


def is_primary() -> bool:
    """Rank 0: the one process that logs and writes checkpoints."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank; a no-op in a world of one."""
    if world_size() > 1:
        dist.barrier()
