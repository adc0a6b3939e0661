"""``idle.<cell>``: percent of the window's time in which no operation ran
on the device: one minus the device's busy time a batch or step (the
union of its activity intervals in the profiled slice, over the units
the slice holds) over the window's host time a batch or step.  The
profiler stretches the host's side of the slice, not the device's, so
the busy time is taken from the slice and the time from the window."""


def read(name: str, obs: dict):
    s, units, unit_s = (obs.get("slice"), obs.get("slice_units"),
                        obs.get("unit_s"))
    if s is None or not units or not unit_s or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / units / unit_s)
