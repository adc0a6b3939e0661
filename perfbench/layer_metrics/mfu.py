"""``<what>_mfu``: the whole workload's share of the bf16 peak over the
window, in percent: the model operations of the window's work
(``counts.py``) over its time."""

from __future__ import annotations

from ..counts import BF16_FLOPS


def read(name: str, obs: dict):
    if not obs.get("flops") or not obs.get("timed_s"):
        return None
    return 100.0 * obs["flops"] / obs["timed_s"] / BF16_FLOPS
