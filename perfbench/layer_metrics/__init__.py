"""Readers of the per-layer metrics, each ``read(name, obs) -> float |
None``.  A metric's family is its name up to the first dot; its reader
is ``<family>.py`` where there is one, else the module named by the
family's last word: ``<kernel>_roofline`` is read by ``roofline.py``,
``<span>_ms`` by ``ms.py``, ``<what>_mfu`` by ``mfu.py``.  ``obs`` holds
what the driver observed in a ``--trace 1`` run: ``layers`` (ms of each
call into a layer in the window, from its stamps, by span name),
``timed_s``, ``unit_s`` and ``flops`` (the window's time, its time a
batch or step, and the model operations of the work it completed),
``slice`` (the profiled slice, ``trace.Slice``) with ``slice_units``
(the batches or steps it holds) and ``bounds`` (per kernel id, the bound
of each call into the kernel that the slice holds).  A reader that finds
nothing to read returns None, and the metric is left out of the line."""

from __future__ import annotations

import importlib
from pathlib import Path


def reader(metric: str):
    """The module that reads ``metric``."""
    family = metric.split(".", 1)[0]
    here = Path(__file__).resolve().parent
    module = (family if (here / f"{family}.py").is_file()
              else family.rsplit("_", 1)[-1])
    return importlib.import_module(f"{__name__}.{module}")


def read(metric: str, obs: dict):
    return reader(metric).read(metric, obs)
