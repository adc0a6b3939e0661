"""The collectives of data-parallel training.

The JAX package writes its train steps in global view: the batch is
sharded over the mesh's ``data`` axis and XLA inserts the reductions
(``mas_tpu/parallel/mesh.py``).  The port runs one process a rank and
calls them itself:

  * ``mean_`` — the gradient mean: one flat fp32 ``all_reduce`` a dtype,
    divided by the world size, written back in place;
  * ``mean_over_ranks`` — a differentiable mean (batch statistics): its
    backward all-reduces the gradient, so after the gradient mean each
    rank holds the gradient of the global batch's loss;
  * ``gather_rows`` — every rank's rows in rank order, on every rank;
  * ``broadcast_`` — rank 0's values on every rank;
  * ``reduce_metrics`` — logged scalars as the global batch's means.

Each is the identity when no process group was joined
(``distributed.initialize`` outside a launcher), so one process computes
exactly what it did before.  In a launched world of one they run over
the process group and change no bit.  Every rank must call them in the
same order.  Only ``all_reduce`` and ``broadcast`` are used: gloo runs
both on CUDA tensors, so ranks that share a card (gloo) and ranks on
cards of their own (NCCL) take one code path.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist


def active() -> bool:
    """True once a process group was joined."""
    return dist.is_initialized()


def mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its mean over ranks, in place: one flat fp32
    ``all_reduce`` per dtype."""
    if not active() or not tensors:
        return
    n = dist.get_world_size()
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1).float() for t in group])
        dist.all_reduce(flat)
        flat.div_(n)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))


def mean_over_ranks(*tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Differentiable mean over ranks of same-shaped tensors, in one
    ``all_reduce``; the inputs themselves outside a process group."""
    if not active():
        return tensors
    from torch.distributed.nn.functional import all_reduce

    total = all_reduce(torch.stack(tensors))
    return tuple((total / dist.get_world_size()).unbind(0))


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """x [b, ...] of each rank -> [world * b, ...], rank 0's rows first,
    on every rank (not differentiable).  An ``all_reduce`` of the rows
    placed in zeros: exact, but for -0.0 which comes back as +0.0."""
    if not active():
        return x
    n = dist.get_world_size()
    out = x.new_zeros((n,) + tuple(x.shape))
    out[dist.get_rank()] = x
    dist.all_reduce(out)
    return out.reshape((n * x.shape[0],) + tuple(x.shape[1:]))


def broadcast_(x: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``x`` on every rank, in place; returns ``x``."""
    if active():
        dist.broadcast(x, src=0)
    return x


def reduce_metrics(metrics: Dict) -> Dict:
    """The float scalar tensors of ``metrics`` as their means over ranks
    (one ``all_reduce``); the other entries as they are."""
    if not active():
        return metrics
    keys = [k for k, v in metrics.items()
            if torch.is_tensor(v) and v.numel() == 1
            and v.is_floating_point()]
    if not keys:
        return metrics
    vals = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    mean_([vals])
    out = dict(metrics)
    out.update({k: v for k, v in zip(keys, vals.unbind(0))})
    return out
