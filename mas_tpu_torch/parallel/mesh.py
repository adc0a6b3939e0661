"""The data axis of the mesh, as ``mas_tpu/parallel/mesh.py`` and the
batch arithmetic of ``mas_tpu/cli.py::_global_batch`` and
``mas_tpu/train/loop.py::_loop``.

One rank holds one device, so the data axis spans the world
(``MeshConfig.shape(world)``), and the counterpart of ``shard_batch`` is
each rank's own rows: the loader of rank r yields the r-th share of the
global batch of ``batch_size`` x data rows.
"""

from __future__ import annotations

from ..utils.config import ConfigError, TrainConfig


def rank_batch(cfg: TrainConfig, world: int) -> int:
    """Rows a rank's loader yields: ``batch_size`` (per replica) x the
    data axis / the process count, with the JAX ``ConfigError``s."""
    data, _ = cfg.mesh.shape(world)
    total = cfg.batch_size * data
    if total % world:
        raise ConfigError(
            f"global batch {total} (batch_size {cfg.batch_size} x "
            f"data axis {data}) must be divisible by the process count "
            f"{world}")
    return total // world


def batch_is_sharded(rows: int, world: int, data: int,
                     allow_replicated_batch: bool) -> bool:
    """True when the global batch of ``rows`` x ``world`` rows tiles the
    data axis, so each rank steps on its own share; False when it does not
    and ``allow_replicated_batch`` takes it replicated; else JAX's
    ``ValueError``.  With one device a rank the data axis is the world
    size, so a rank's rows always tile it."""
    if (rows * world) % data == 0:
        return True
    if allow_replicated_batch:
        return False
    raise ValueError(
        f"global batch {rows * world} (host batch {rows} x {world} "
        f"processes) does not tile the data axis ({data}); fix "
        f"batch_size/mesh, or set train.allow_replicated_batch=true for "
        f"tiny tests")
