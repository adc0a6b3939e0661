"""``<kernel>_roofline.<cell>``: the kernel's share of its roofline over
the profiled slice, in percent: the sum of the bounds of its calls there
(``counts.py``) over the device time of all its launches (B6 launches
three kernels a call).  The kernel id is the family's first word: B2 for
``b2_roofline``."""

from __future__ import annotations


def read(name: str, obs: dict):
    kid = name.split(".", 1)[0].rsplit("_", 1)[0].upper()
    s, bounds = obs.get("slice"), obs.get("bounds", {}).get(kid)
    seconds = s.kernel_s.get(kid, 0.0) if s is not None else 0.0
    if not bounds or seconds <= 0:
        return None
    return 100.0 * sum(bounds) / seconds
