"""The span slice: one more profiled stretch of a ``--trace 1`` run (one
batch, or ``train.SLICE_STEPS`` steps: as many units as the traced slice
of ``trace.py`` holds), with the program's spans on
(``mas_tpu_torch/utils/spans.py``), so that each of its ranges sits on the
profiler's clock as a ``mas.<span>`` user annotation.

Device intervals are the device's activity (kernels, copies, sets); the
ranges that the annotations leave on the device's timeline are not work.
Each idle stretch between device intervals, and before the first and after
the last within the profiled stretch, goes to the innermost span open at
its middle, or to ``untraced`` where none is.  Within each span the
outermost host operator calls of each thread are counted (dispatcher ops
and autograd functions; not CUDA runtime calls, not annotations), each by
the innermost span open at its start.

It is meant to run after the traced slice of ``trace.py``, which keeps
the spans off; the traffic drivers do not record it yet, so no cell reads
it.  A program without spans gives no span slice (``record`` returns
None), and every reader of it finds nothing.
"""

from __future__ import annotations

import importlib
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from . import harness, trace

UNTRACED = "untraced"
PREFIX = "mas."
DEVICE, SPAN, OP = "device", "span", "op"
RUNTIME = re.compile(r"cu(da)?[A-Z]")     # cudaLaunchKernel, cuLaunchKernel

# (kind, name, thread, start us, end us)
Event = Tuple[str, str, int, float, float]


@dataclass
class SpanSlice:
    busy_s: float
    idle_s: float
    # by span name: spans closed in the slice, outermost operator calls
    # inside them, idle seconds for which they were the innermost span
    # (``untraced`` among the idle)
    count: Dict[str, int] = field(default_factory=dict)
    ops: Dict[str, int] = field(default_factory=dict)
    idle: Dict[str, float] = field(default_factory=dict)


def program_spans():
    """The program's span module, or None where the program has none."""
    try:
        return importlib.import_module("mas_tpu_torch.utils.spans")
    except ImportError:
        return None


def enable(on: bool) -> None:
    spans = program_spans()
    if spans is not None:
        spans.enable(on)


def drain() -> list:
    """The program's span records since the last drain (none without
    spans)."""
    spans = program_spans()
    return spans.drain() if spans is not None else []


def _name_kind(e) -> str:
    """An event's activity kind where torch's events lack it (torch 2.11's
    do), from its name: program spans by their prefix, CUDA API calls
    (``cudaLaunchKernel``, ``cuLaunchKernel``) by theirs, the profiler's
    own events (``Buffer Flush``, ``Command Buffer Full``: names of words,
    no ``::``) as overhead, the rest of the host's events operator
    calls."""
    name = e.name()
    if name.startswith(PREFIX):
        return "user_annotation"
    if e.device_type() != e.device_type().CPU:
        return "kernel"
    if RUNTIME.match(name):
        return "cuda_runtime"
    return "overhead" if " " in name and "::" not in name else "cpu_op"


def classify(events: Iterable) -> List[Event]:
    """Kineto events -> the slice's events: device activity, program
    spans (the ``mas.`` prefix taken off) and host operator calls; the
    rest (runtime calls, other annotations) is left out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out: List[Event] = []
    kind_of = None
    for e in events:
        if kind_of is None:
            kind_of = (type(e).activity_type
                       if getattr(type(e), "activity_type", None) is not None
                       else _name_kind)
        name, kind = e.name(), kind_of(e)
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        if e.device_type() == cuda:
            if not (kind.endswith("user_annotation")
                    or name.startswith(PREFIX)):
                out.append((DEVICE, name, 0, start, end))
        elif name.startswith(PREFIX):
            out.append((SPAN, name[len(PREFIX):], _thread(e), start, end))
        elif kind == "cpu_op":
            out.append((OP, name, _thread(e), start, end))
    return out


def _thread(e) -> int:
    thread = getattr(e, "start_thread_id", None)
    return thread() if thread is not None else 0


def _innermost(spans: List[Tuple[float, float, str]],
               points: List[float]) -> List[str]:
    """For each of ``points`` (sorted), the name of the innermost of
    ``spans`` (sorted by start, nested) open there, or UNTRACED."""
    names, open_, i = [], [], 0
    for p in points:
        while i < len(spans) and spans[i][0] <= p:
            open_.append(spans[i])
            i += 1
        open_ = [s for s in open_ if s[1] >= p]
        names.append(open_[-1][2] if open_ else UNTRACED)
    return names


def _outermost(ops: List[Tuple[float, float, str]]) -> List[float]:
    """Starts of the calls of one thread that no other call holds.  The
    profiler's clock is coarse: a call that starts where another starts or
    ends is taken as held by it (a call the program makes next starts a
    dispatch later)."""
    starts, end = [], float("-inf")
    for s, e, _ in sorted(ops, key=lambda x: (x[0], -x[1])):
        if s > end:
            starts.append(s)
            end = e
    return starts


def summarize(events: List[Event]) -> SpanSlice:
    if not events:
        return SpanSlice(0.0, 0.0)
    busy = trace.union([(s, e) for k, _, _, s, e in events if k == DEVICE])
    # an enclosing span before the spans it holds, at a shared start too
    spans = sorted(((s, e, n) for k, n, _, s, e in events if k == SPAN),
                   key=lambda x: (x[0], -x[1]))
    lo = min(s for _, _, _, s, _ in events)
    hi = max(e for _, _, _, _, e in events)
    edges = [(lo, lo)] + busy + [(hi, hi)]
    gaps = [(a, b) for (_, a), (b, _) in zip(edges, edges[1:]) if b > a]
    idle: Dict[str, float] = defaultdict(float)
    for (a, b), name in zip(gaps, _innermost(
            spans, [(a + b) / 2 for a, b in gaps])):
        idle[name] += (b - a) / 1e6
    by_thread: Dict[int, list] = defaultdict(list)
    for k, n, t, s, e in events:
        if k == OP:
            by_thread[t].append((s, e, n))
    starts = sorted(s for ops in by_thread.values()
                    for s in _outermost(ops))
    ops: Dict[str, int] = defaultdict(int)
    for name in _innermost(spans, starts):
        ops[name] += 1
    count: Dict[str, int] = defaultdict(int)
    for _, _, name in spans:
        count[name] += 1
    return SpanSlice(busy_s=sum(e - s for s, e in busy) / 1e6,
                     idle_s=sum(idle.values()), count=dict(count),
                     ops=dict(ops), idle=dict(idle))


def record(fn: Callable[[], object], device) -> Optional[SpanSlice]:
    """Run ``fn`` under the profiler with the program's spans on, and
    summarize it; None, without running ``fn``, where the program has no
    spans."""
    spans = program_spans()
    if spans is None:
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    spans.enable(True)
    try:
        with profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])) as prof:
            fn()
            sync()
    finally:
        spans.enable(False)
        spans.drain()       # the slice's own records are not the window's
    harness.log("span slice profiled")
    out = summarize(classify(prof.profiler.kineto_results.events()))
    harness.log("span slice read")
    return out
