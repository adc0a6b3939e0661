"""Stamps on the device's timeline around calls into the program's layers.

A stamp is a CUDA event recorded on the current stream (the host clock on
a CPU run), so taking one never waits for the device; the stamps are read
after the window's closing synchronize.  ``wrap`` shadows a method of one
object with a call that stamps around it: the program's code is not
touched.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch


class Marks:
    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def stamp(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def wrap(obj, attr: str, before: Optional[Callable] = None,
         after: Optional[Callable] = None) -> None:
    """``obj.attr(...)`` calls ``before(*args)`` first and ``after(out)``
    with its result last."""
    inner = getattr(obj, attr)

    def call(*args, **kwargs):
        if before is not None:
            before(*args, **kwargs)
        out = inner(*args, **kwargs)
        if after is not None:
            after(out)
        return out

    setattr(obj, attr, call)
