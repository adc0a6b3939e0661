"""What the traffic drivers share: the run's parameters, seeded token
traffic, and the end of the program's part of a run."""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from .spec import Cell
from .weights import sub_seed

# sub-seeds of one run's seed, by use
TRANSFORMER_WEIGHTS, VQ_WEIGHTS, TRAFFIC, SAMPLER, CHECK = 1, 2, 3, 4, 5


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device

    def sub_seed(self, use: int) -> int:
        return sub_seed(self.seed, use)


def captions(rng: np.random.Generator, shape, t: dict, lengths) -> np.ndarray:
    """Text ids [*shape, text_length]: ``lengths`` (lo, hi) caption tokens
    drawn from the text vocabulary, then pad (0)."""
    n = t["text_length"]
    size = rng.integers(lengths[0], lengths[1] + 1, shape)
    ids = rng.integers(1, t["text_vocab_size"] - n, (*shape, n))
    return np.where(np.arange(n) < size[..., None], ids, 0)


def tokens(rng: np.random.Generator, shape, vocab: int,
           n: int) -> np.ndarray:
    return rng.integers(0, vocab, (*shape, n))


def on(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def memory_peak(device: torch.device) -> int:
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize()
    return int(torch.cuda.max_memory_allocated(device))


def release(device: torch.device) -> None:
    """Give back the program's memory before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def log(what: str) -> None:
    """A set-up phase's end, on standard error, with the process clock."""
    print(f"perfbench: {time.perf_counter():.3f} {what}", file=sys.stderr,
          flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()
