"""Process bootstrap, as ``mas_tpu/parallel/distributed.py``, and the
(data, model) rank grid of ``mas_tpu/parallel/mesh.py::make_mesh``.

``initialize`` reads the launcher's environment (``torchrun`` sets
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``) before it touches a device, and joins
the process group.  Without that environment it is a no-op: one process,
no process group, and every collective of ``collectives`` is the
identity.

The ranks form the grid of ``MeshConfig.shape(world)``: rank r is data
index r // model and model index r % model, the row-major reshape of the
JAX mesh.  The ranks of one data index (a model group) hold the shards of
one tensor-parallel model and read the same rows; the ranks of one model
index (a data group) step on different rows and average their gradients.
Every rank makes every group with ``dist.new_group``, in one order.

Each rank runs on one device: ``cuda:LOCAL_RANK % device_count`` for a
CUDA device type, the CPU otherwise.  The backend follows where the ranks
live: NCCL when every local rank has a card of its own, gloo when local
ranks share a card (NCCL refuses two ranks on one device) or run on the
CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from ..utils.config import ConfigError, MeshConfig

LAUNCH_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR")


@dataclass(frozen=True)
class Grid:
    """This rank's place in the (data, model) grid and its two groups.

    ``data_group`` is what the data-parallel collectives run over: the
    world when ``model`` is 1 (a launched world of one still runs them),
    else the ranks of this model index, or None where this rank is alone
    on the data axis.  ``model_group`` is the ranks of this data index,
    None when ``model`` is 1."""

    data: int = 1
    model: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: Any = None
    model_group: Any = None


_grid = Grid()


def grid() -> Grid:
    """The grid ``initialize`` laid out; one process's outside a launcher
    (the process group is process-wide state, and so is its grid)."""
    return _grid


def model_shard() -> Tuple[int, int]:
    """(model index, model size) of this rank: the ``shard`` argument of
    a tensor-parallel ``MakeAScene``."""
    return _grid.model_index, _grid.model


def _make_grid(data: int, model: int) -> Grid:
    r = dist.get_rank()
    if model == 1:
        return Grid(data, 1, r, 0, dist.group.WORLD, None)
    data_groups = [dist.new_group([i * model + j for i in range(data)])
                   for j in range(model)]
    model_groups = [dist.new_group([i * model + j for j in range(model)])
                    for i in range(data)]
    i, j = divmod(r, model)
    return Grid(data, model, i, j, data_groups[j] if data > 1 else None,
                model_groups[i])


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


def initialize(device_type: str = "cuda",
               mesh: Optional[MeshConfig] = None) -> dict:
    """Join the process group when launched (once; a repeat call joins
    nothing), lay the ranks out as ``mesh`` says (every rank on the data
    axis when None; once, when the group is joined) and return the
    topology: the JAX keys ``process_index``, ``process_count``,
    ``local_devices``, ``global_devices`` and ``backend`` (the process
    group's, None for one process) and ``device``, this rank's device;
    ``grid()`` holds the layout.  A mesh that does not cover the world
    raises JAX's ``ConfigError`` before any rank joins; so does a repeat
    call whose mesh has another shape than the grid laid out."""
    global _grid
    world = int(os.environ["WORLD_SIZE"]) if launched() else 1
    shape = mesh.shape(world) if mesh is not None else (world, 1)
    device = rank_device(device_type)
    if launched() and not dist.is_initialized():
        backend = backend_for(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]),
            device_id=device if backend == "nccl" else None)
    if dist.is_initialized():
        if _grid.data_group is None and _grid.model_group is None:
            _grid = _make_grid(*shape)
        elif (_grid.data, _grid.model) != shape:
            raise ConfigError(
                f"the ranks are laid out as a {_grid.data} x {_grid.model} "
                f"(data, model) grid; a {shape[0]} x {shape[1]} mesh cannot "
                "be laid out again in this process")
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
