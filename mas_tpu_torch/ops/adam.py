"""Adam's update over a list of fp32 tensors (kernel B13), as
``train/state.py::Adam`` applies it:

  mu = (1 - b1) g + b1 mu,  nu = (1 - b2) g^2 + b2 nu,
  p -= lr (mu / bc1) / (sqrt(nu / bc2) + eps)

with the bias corrections ``bc1``, ``bc2`` computed by the caller, each
tensor updated in place.

B13 replaces no kernel of the JAX package, where optax's update is fused
by XLA; the port's update was ``adam_update_plain``, 15 eager operations
a tensor, so a transformer_512 step made 5,970 launches for its 398
tensors and the card waited on the host.  B13 is CUDA C++
(``csrc/adam.cu``, where its design and what bounds it are set out): one
pass that reads p, g, mu and nu once and writes p, mu and nu once, over up
to ``TENSORS_PER_LAUNCH`` tensors a launch.  ``launch_plan`` cuts a list
into launches and each tensor into tiles of ``TILE`` elements, from the
tensors' sizes alone; the wrapper passes each launch's pointers and
scalars by value, so a launch allocates nothing, copies nothing to the
device and never synchronizes.  The scalars are the fp32 roundings of the
same doubles the plain loop uses, and the kernel rounds where PyTorch's
CUDA kernels round in that loop, so on the card mu and nu come out
bitwise equal to ``adam_update_plain``'s, p bitwise or within an ulp.
"""

from __future__ import annotations

import array
import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from .. import _build

# as csrc/adam.cu compiles them: elements a tile, tensors a launch, and
# the bytes of one launch's table (four pointers, numel and first tile a
# tensor; the end tile, the count and eight fp32 scalars) against the
# kernel-parameter limit that every CUDA toolkit takes
TILE = 2048
TENSORS_PER_LAUNCH = 90
PARAM_BYTES = 44 * TENSORS_PER_LAUNCH + 40
PARAM_LIMIT = 4096

_F32 = torch.float32


class Launch(NamedTuple):
    """One launch of B13: tensors ``first`` to ``first + count - 1`` of
    the list; tensor ``first + j`` owns tiles [tile_starts[j],
    tile_starts[j + 1]) of the launch, ``ceil(numel / TILE)`` of them."""
    first: int
    count: int
    tile_starts: Tuple[int, ...]

    @property
    def tiles(self) -> int:
        return self.tile_starts[-1]


def launch_plan(numels: Sequence[int]) -> Tuple[Launch, ...]:
    """The launches of one update over tensors of ``numels`` elements:
    consecutive runs of at most ``TENSORS_PER_LAUNCH`` tensors, as even in
    count as they can be."""
    n = len(numels)
    groups = -(-n // TENSORS_PER_LAUNCH)
    plan, first = [], 0
    for k in range(groups):
        count = n // groups + (k < n % groups)
        starts = [0]
        for e in numels[first:first + count]:
            starts.append(starts[-1] + -(-e // TILE))
        if starts[-1] >= 2 ** 31:
            raise ValueError("adam_update: over 2^31 tiles in one launch")
        plan.append(Launch(first, count, tuple(starts)))
        first += count
    return tuple(plan)


@functools.lru_cache(maxsize=None)
def _tables(numels: Tuple[int, ...]):
    """``launch_plan(numels)`` with each launch's numels and tile starts
    as the ctypes arrays the C function takes, made once per list of
    sizes."""
    return tuple(
        (lc, (ctypes.c_longlong * lc.count)(
            *numels[lc.first:lc.first + lc.count]),
         (ctypes.c_int * (lc.count + 1))(*lc.tile_starts))
        for lc in launch_plan(numels) if lc.tiles)


def adam_update_plain(params, grads, mus, nus, lr: float, b1: float,
                      b2: float, eps: float, bc1: float, bc2: float) -> None:
    """Plain twin of B13: the update, tensor by tensor, in eager
    operations."""
    for p, g, mu, nu in zip(params, grads, mus, nus):
        mu.copy_((1 - b1) * g + b1 * mu)
        nu.copy_((1 - b2) * g.square() + b2 * nu)
        p.add_((mu / bc1) / ((nu / bc2).sqrt() + eps), alpha=-lr)


def _first_not(ok, ts) -> int:
    return next(k for k, t in enumerate(ts) if not ok(t))


def check_tensors(params, grads, mus, nus) -> int:
    """Raise unless the four lists are equally long and each position
    holds four contiguous fp32 tensors of one shape, all on one device;
    returns that device's index."""
    lists = (("param", params), ("grad", grads), ("mu", mus), ("nu", nus))
    if len({len(ts) for _, ts in lists}) != 1:
        raise ValueError("adam_update: lists of " + ", ".join(
            f"{len(ts)} {name}s" for name, ts in lists))
    shapes = [p.shape for p in params]
    dev = params[0].get_device()
    for name, ts in lists:
        if not all(t.dtype is _F32 for t in ts):
            k = _first_not(lambda t: t.dtype is _F32, ts)
            raise TypeError(f"adam_update: {name} {k} is {ts[k].dtype}, "
                            "not float32")
        if [t.shape for t in ts] != shapes:
            k = next(k for k, t in enumerate(ts) if t.shape != shapes[k])
            raise ValueError(f"adam_update: {name} {k} has shape "
                             f"{tuple(ts[k].shape)}, its param "
                             f"{tuple(shapes[k])}")
        if not all(t.is_contiguous() for t in ts):
            k = _first_not(torch.Tensor.is_contiguous, ts)
            raise ValueError(f"adam_update: {name} {k} is not contiguous")
        if not all(t.get_device() == dev for t in ts):
            k = _first_not(lambda t: t.get_device() == dev, ts)
            raise ValueError(f"adam_update: {name} {k} is on "
                             f"{ts[k].device}, param 0 on "
                             f"{params[0].device}")
    return dev


def adam_update(params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor],
                mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor],
                lr: float, b1: float, b2: float, eps: float, bc1: float,
                bc2: float) -> None:
    """Adam's update of each ``params[k]`` with ``grads[k]`` and its
    moments ``mus[k]``, ``nus[k]``, in place.  Kernel B13 for CUDA
    tensors (``len(launch_plan(...))`` launches, counted in
    ``adam_update.launches``), the plain twin for CPU tensors."""
    if not params:
        return
    kind = params[0].device.type
    if kind == "cpu":
        adam_update_plain(params, grads, mus, nus, lr, b1, b2, eps, bc1, bc2)
        return
    if kind != "cuda":
        raise ValueError(f"adam_update runs on cpu or cuda, got "
                         f"{params[0].device}")
    dev = check_tensors(params, grads, mus, nus)
    ptrs = array.array("q", [t.data_ptr() for ts in (params, grads, mus, nus)
                             for t in ts])
    lib = _build.library()
    stream = _build.stream(dev)
    for lc, numels, starts in _tables(tuple(p.numel() for p in params)):
        status = lib.mas_adam_update(
            ptrs.buffer_info()[0], len(params), lc.first, lc.count, numels,
            starts, 1 - b1, b1, 1 - b2, b2, bc1, bc2, eps, -lr, dev, stream)
        _build.check(status, "adam_update")
        adam_update.launches += 1


adam_update.launches = 0
