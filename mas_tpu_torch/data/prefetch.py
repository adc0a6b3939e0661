"""Host-side batch prefetching, as ``mas_tpu/data/prefetch.py``.

A daemon thread keeps a small queue of ready numpy batches ahead of the
device's step, so tar reads, JPEG decode and seg-map assembly overlap it.
Threads suffice: PIL, numpy and tar reads release the GIL, and batches
stay in the process's memory with no pickling.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional


class PrefetchIterator:
    """Wrap a batch iterable; produce from a background thread.

    ``size`` bounds host memory (size * batch bytes).  An exception in the
    producer is raised to the consumer at the position of the failed
    batch.
    """

    _DONE = object()

    def __init__(self, iterable: Iterable, size: int = 2):
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(size, 1))
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._produce, args=(iterable,), daemon=True)
        self._thread.start()

    def _produce(self, iterable) -> None:
        try:
            for item in iterable:
                self._queue.put(item)
        except BaseException as exn:                   # noqa: BLE001
            self._err = exn
        finally:
            self._queue.put(self._DONE)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def prefetch(iterable: Iterable, size: int = 2) -> PrefetchIterator:
    return PrefetchIterator(iterable, size)


def parallel_map(fn, iterable: Iterable, workers: int = 4,
                 inflight: Optional[int] = None) -> Iterator:
    """Order-preserving map of ``fn`` over ``iterable`` on a thread pool
    (inline when ``workers`` <= 0).  ``inflight`` bounds the submitted
    but unconsumed items (host memory), 4 * workers by default.  An
    exception from ``fn`` is raised at the failed item's position."""
    import collections
    from concurrent.futures import ThreadPoolExecutor

    if workers <= 0:
        yield from map(fn, iterable)
        return
    bound = inflight or 4 * workers
    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending: "collections.deque" = collections.deque()
        for item in iterable:
            pending.append(pool.submit(fn, item))
            if len(pending) >= bound:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()
