"""``b14_roofline.<cell>``: B14's (the Mamba2 decode step's state
update's) share of its roofline over the profiled slice, in percent: the
sum of its calls' bounds there (``traffic/serve_granite.py::b14_bound_s``
a call, at the rows of the batch: the fp32 state read and written once,
x, B, C and Δ in, y out) over the device time of its kernels, found by
name (``ssm_update_kernel``) in the profiler's events, since the frozen
kernel table predates B14.  A program without B14 leaves it unread."""

from __future__ import annotations


def read(name: str, obs: dict):
    b14 = obs.get("b14") or {}
    if not b14.get("bound_s") or not b14.get("device_s"):
        return None
    return 100.0 * b14["bound_s"] / b14["device_s"]
