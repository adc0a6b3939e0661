"""Program spans: named, nested ranges of the host's time at the port's
layer boundaries (the sampling call, prefill, cache seeding and, in it,
the hybrid block's conv states, decode step, sampling head, VQ decode;
the train step, its forward, backward and Adam step).

Spans are off unless ``enable(True)`` turns them on; nothing in the port
turns them on, and no config field, flag or environment variable does.
Off, ``span(name)`` costs one check of a module-level bool and returns a
shared no-op context manager: no clock read, no allocation, no profiler
call.  On, each span leaves a ``Record``, a named tuple (name, id, the
enclosing span's id, the id of the outermost span it sits in, its start
and end on ``time.perf_counter_ns``), in an in-memory buffer of at most
``CAP`` records; past the cap records are dropped and counted.  Only while a
``torch.profiler`` is running does a span also open
``torch.profiler.record_function("mas." + name)``, which puts it on the
profiler's clock, the clock of the device trace.  Nothing is written out:
the caller takes the records with ``drain()``.

    from mas_tpu_torch.utils import spans
    spans.enable(True)
    ...                                  # serve or train as usual
    records = spans.drain()
    spans.enable(False)
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import List, NamedTuple, Optional

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

CAP = 1 << 16

_on = False
_records: List["Record"] = []
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()


class Record(NamedTuple):
    name: str
    id: int
    parent: Optional[int]     # the enclosing span's id, None at a root
    root: int                 # the outermost enclosing span's id (own id)
    start_ns: int
    end_ns: int


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "id", "parent", "root", "start_ns", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        top = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if top is None else top.id
        self.root = self.id if top is None else top.root
        self._range = None
        if _profiler_enabled():
            self._range = record_function("mas." + self.name)
            self._range.__enter__()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _stack().pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        _keep(Record(self.name, self.id, self.parent, self.root,
                     self.start_ns, end))
        return False


def _keep(record: Record) -> None:
    global _dropped
    if len(_records) < CAP:
        _records.append(record)
    else:
        _dropped += 1


def span(name: str):
    """A context manager around one call into a layer."""
    return _Span(name) if _on else _NOOP


def enable(on: bool) -> None:
    """Turn spans on or off; spans already open still close and record."""
    global _on
    _on = bool(on)


def dropped() -> int:
    """Records dropped at the cap since the last ``drain()``."""
    return _dropped


def drain() -> List[Record]:
    """The records kept since the last drain, in the order the spans
    closed; clears the buffer and the count of dropped records."""
    global _records, _dropped
    out, _records, _dropped = _records, [], 0
    return out
