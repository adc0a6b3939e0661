"""``<span>_ms.<cell>``: mean ms of one call into the layer, from the
stamps of the span named by the family (``prefill_ms``, ``adam_ms``) in
the window, on the device's timeline."""

from __future__ import annotations


def read(name: str, obs: dict):
    values = obs.get("layers", {}).get(name.split(".", 1)[0]) or []
    return sum(values) / len(values) if values else None
