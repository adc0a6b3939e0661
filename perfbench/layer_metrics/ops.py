"""``<span>_ops.<cell>``: outermost host operator calls (dispatcher ops
and autograd functions) inside one program span named by the family
(``decode_step_ops``, ``adam_ops``), over the span slice
(``span_slice.py``): its calls in that span over the spans it holds."""

from __future__ import annotations


def read(name: str, obs: dict):
    span = name.split(".", 1)[0].rsplit("_", 1)[0]
    ss = obs.get("span_slice")
    if ss is None or not ss.count.get(span):
        return None
    return ss.ops.get(span, 0) / ss.count[span]
