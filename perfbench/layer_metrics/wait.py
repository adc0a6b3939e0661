"""``<span>_wait.<cell>``: ms the device sat idle inside one program span
named by the family (``decode_step_wait``, ``adam_wait``), the span being
the innermost one open; ``untraced_wait``: ms a batch or step that the
device sat idle outside every span.

The window's idle time a batch or step is taken as ``idle.py`` takes it
(its host time a unit less the traced slice's device busy time a unit);
the span slice (``span_slice.py``, as many units as the traced slice)
shares it out by its idle seconds in each span, and a span's share is
divided by the spans a unit.  The profiler stretches the host's side of a
slice, so only the shares come from the span slice.  Over the spans, the
waits times their counts a unit, plus ``untraced_wait``, are the window's
idle time a unit."""

from __future__ import annotations

from ..span_slice import UNTRACED


def read(name: str, obs: dict):
    span = name.split(".", 1)[0].rsplit("_", 1)[0]
    ss, s = obs.get("span_slice"), obs.get("slice")
    units, unit_s = obs.get("slice_units"), obs.get("unit_s")
    if (ss is None or s is None or not units or not unit_s
            or s.busy_s <= 0 or ss.busy_s <= 0 or ss.idle_s <= 0):
        return None
    idle_ms = 1e3 * (unit_s - s.busy_s / units) * ss.idle.get(span, 0.0) \
        / ss.idle_s
    if span == UNTRACED:
        return idle_ms
    per_unit = ss.count.get(span, 0) / units
    return idle_ms / per_unit if per_unit else None
