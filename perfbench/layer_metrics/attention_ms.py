"""``attention_ms.<cell>``: device ms a step of the attention kernels (B1
and B6, by kernel id) over the profiled slice."""


def read(name: str, obs: dict):
    s, steps = obs.get("slice"), obs.get("slice_units")
    if s is None or not steps:
        return None
    seconds = s.kernel_s.get("B1", 0.0) + s.kernel_s.get("B6", 0.0)
    return 1e3 * seconds / steps if seconds > 0 else None
