"""The traced slice: what the device did in a bounded stretch at the end
of a ``--trace 1`` run, from ``torch.profiler``'s own timeline.

Busy time is the union of the device's activity intervals (kernels,
copies, sets), so overlapping kernels count once; the window is the host
clock's length of the profiled stretch, which ends in a synchronize.
Idle gaps are the stretches between busy intervals, each named by the
outermost host operation running at its middle (or ``host, between
operations``).
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

from .kernels import kernel_id

# (name, on the device, start us, end us)
Event = Tuple[str, bool, float, float]
BETWEEN = "host, between operations"


@dataclass
class Slice:
    window_s: float
    busy_s: float
    # kernel id -> device seconds of its launches
    kernel_s: Dict[str, float] = field(default_factory=dict)
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _outermost(host: List[Tuple[float, float, str]]):
    """Host operations not inside another, sorted by start."""
    top: List[Tuple[float, float, str]] = []
    for s, e, name in sorted(host):
        if top and s < top[-1][1]:
            continue
        top.append((s, e, name))
    return top


def summarize(events: List[Event], window_s: float, top: int = 10) -> Slice:
    device = [(s, e, n) for n, on_dev, s, e in events if on_dev]
    busy = union([(s, e) for s, e, _ in device])
    kernel_s: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, name in device:
        kid = kernel_id(name)
        if kid is not None:
            kernel_s[kid] += (e - s) / 1e6
        by_name[name[:120]] += (e - s) / 1e6
    host = _outermost([(s, e, n) for n, on_dev, s, e in events
                       if not on_dev])
    starts = [s for s, _, _ in host]
    gaps: Dict[str, float] = defaultdict(float)
    if busy:
        lo = min(starts[0], busy[0][0]) if starts else busy[0][0]
        edges = [(lo, lo)] + busy
        for (_, prev_end), (nxt, _) in zip(edges, edges[1:]):
            if nxt <= prev_end:
                continue
            mid = (prev_end + nxt) / 2
            i = bisect.bisect_right(starts, mid) - 1
            name = (host[i][2] if i >= 0 and host[i][1] >= mid else BETWEEN)
            gaps[name] += (nxt - prev_end) / 1e6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])[:top]]
    return Slice(window_s=window_s,
                 busy_s=sum(e - s for s, e in busy) / 1e6,
                 kernel_s=dict(kernel_s), device_ops=rank(by_name),
                 idle_gaps=rank(gaps))


def _events(prof) -> List[Event]:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        out.append((e.name(), e.device_type() == cuda, start,
                    start + e.duration_ns() / 1e3))
    return out


def record(fn: Callable[[], object], device) -> Tuple[object, Slice]:
    """Run ``fn`` under the profiler; its result and the slice (on a CPU
    run, of host operations alone)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        window = time.perf_counter() - t0
    return out, summarize(_events(prof), window)
