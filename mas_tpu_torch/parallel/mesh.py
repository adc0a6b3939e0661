"""The data axis of the mesh, as ``mas_tpu/parallel/mesh.py`` and the
batch arithmetic of ``mas_tpu/cli.py::_global_batch`` and
``mas_tpu/train/loop.py::_loop``.

One rank holds one device, so the mesh is the rank grid
(``MeshConfig.shape(world)``, ``distributed.grid()``), and the
counterpart of ``shard_batch`` is each data index's own rows: the global
batch of ``batch_size`` x data rows comes in data shares of
``batch_size`` rows, and every rank of one data index (the ranks of one
tensor-parallel model) loads the same share.
"""

from __future__ import annotations

from ..utils.config import TrainConfig


def rank_batch(cfg: TrainConfig, world: int) -> int:
    """Rows a rank's loader yields: ``batch_size``, its data index's share
    of the global ``batch_size`` x data rows; JAX's ``ConfigError`` where
    the mesh does not cover the ``world`` ranks."""
    cfg.mesh.shape(world)
    return cfg.batch_size


def batch_is_sharded(rows: int, world: int, data: int,
                     allow_replicated_batch: bool) -> bool:
    """True when the global batch of ``rows`` x ``world`` rows tiles the
    data axis, so each rank steps on its own share; False when it does not
    and ``allow_replicated_batch`` takes it replicated; else JAX's
    ``ValueError``.  ``world`` counts the loaders of different rows (the
    data axis: one device a rank), so a rank's rows always tile it."""
    if (rows * world) % data == 0:
        return True
    if allow_replicated_batch:
        return False
    raise ValueError(
        f"global batch {rows * world} (host batch {rows} x {world} "
        f"processes) does not tile the data axis ({data}); fix "
        f"batch_size/mesh, or set train.allow_replicated_batch=true for "
        f"tiny tests")
