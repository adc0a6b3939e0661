"""``<span>_host.<cell>``: mean host ms of one program span named by the
family (``decode_step_host``, ``adam_host``), over the spans that the
program recorded in the window (``mas_tpu_torch/utils/spans.py``, drained
into ``obs["spans"]``): the host's time from entering the layer to leaving
it, device work it only enqueued not included."""

from __future__ import annotations


def read(name: str, obs: dict):
    span = name.split(".", 1)[0].rsplit("_", 1)[0]
    ms = [(r.end_ns - r.start_ns) / 1e6 for r in obs.get("spans", ())
          if r.name == span]
    return sum(ms) / len(ms) if ms else None
