"""``b12_roofline.<cell>``: B12's (the grouped SwiGLU expert product's)
share of its roofline over the profiled slice, in percent: the sum of
its calls' bounds there (``traffic/serve_lfm2.py::b12_bound_s``, from the
routed pairs and the experts each call touched, as the program's device
counters hold them) over the device time of its kernels, found by name
(``moe_swiglu_``) in the profiler's events, since the frozen kernel table
predates B12.  A program without B12 leaves it unread."""

from __future__ import annotations


def read(name: str, obs: dict):
    b12 = obs.get("b12") or {}
    if not b12.get("bound_s") or not b12.get("device_s"):
        return None
    return 100.0 * b12["bound_s"] / b12["device_s"]
