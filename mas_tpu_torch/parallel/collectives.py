"""The collectives of data- and tensor-parallel training and serving.

The JAX package writes its steps in global view: the batch is sharded
over the mesh's ``data`` axis, the transformer's matmul weights over its
``model`` axis (``mas_tpu/parallel/sharding.py``), and XLA inserts the
reductions.  The port runs one process a rank and calls them itself.

Over the rank's data group (``distributed.grid().data_group``: the ranks
of its model index):

  * ``mean_`` — the gradient mean: one flat fp32 ``all_reduce`` a dtype,
    divided by the data size, written back in place;
  * ``mean_over_ranks`` — a differentiable mean (batch statistics): its
    backward all-reduces the gradient, so after the gradient mean each
    rank holds the gradient of the global batch's loss;
  * ``gather_rows`` — every data index's rows in order, on every rank;
  * ``reduce_metrics`` — logged scalars as the global batch's means.

``broadcast_`` sends global rank 0's values to every rank (state that
every rank holds alike).

Over the rank's model group (the ranks of its data index), for
tensor parallelism (Megatron's pattern; ``models/transformer.py``):

  * ``copy_to_model`` — the identity forward, an all-reduce of the
    gradient backward: where a replicated tensor enters a rank's shard of
    the computation;
  * ``reduce_from_model`` — an all-reduce forward, the identity backward:
    the sum of the ranks' partial results (row-parallel products);
  * ``max_over_model`` — the largest value over the ranks (detached);
  * ``gather_vocab`` — the full vocabulary of vocab-parallel logits;
  * ``vocab_parallel_cross_entropy`` — the loss of vocab-parallel logits
    from three all-reduces of [N] (row max, sum of exponentials, target
    logit), never the logits themselves;
  * ``model_parts`` — every model rank's copy of some tensors (the
    shards a checkpoint gathers).

The sums run in fp32 whatever the tensor's dtype.  Each is the identity
when the group is None: no process group was joined (one process
computes exactly what it did before), or the rank is alone on that axis.
Every rank must call them in the same order.  Only ``all_reduce`` and
``broadcast`` are used: gloo runs both on CUDA tensors, so ranks that
share a card (gloo) and ranks on cards of their own (NCCL) take one code
path.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import torch
import torch.distributed as dist

from .distributed import grid


def active() -> bool:
    """True once a process group was joined."""
    return dist.is_initialized()


def data_size() -> int:
    """Ranks on the data axis (1 outside a process group)."""
    return grid().data


def mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the data group, in place: one
    flat fp32 ``all_reduce`` per dtype."""
    group = grid().data_group
    if group is None or not tensors:
        return
    n = grid().data
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for part in by_dtype.values():
        flat = torch.cat([t.reshape(-1).float() for t in part])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        for t, p in zip(part, flat.split([t.numel() for t in part])):
            t.copy_(p.view_as(t))


def mean_over_ranks(*tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Differentiable mean over the data group of same-shaped tensors, in
    one ``all_reduce``; the inputs themselves without such a group."""
    group = grid().data_group
    if group is None:
        return tensors
    from torch.distributed.nn.functional import all_reduce

    total = all_reduce(torch.stack(tensors), group=group)
    return tuple((total / grid().data).unbind(0))


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """x [b, ...] of each data index -> [data * b, ...], data index 0's
    rows first, on every rank (not differentiable).  An ``all_reduce`` of
    the rows placed in zeros: exact, but for -0.0 which comes back as
    +0.0."""
    g = grid()
    if g.data_group is None:
        return x
    out = x.new_zeros((g.data,) + tuple(x.shape))
    out[g.data_index] = x
    dist.all_reduce(out, group=g.data_group)
    return out.reshape((g.data * x.shape[0],) + tuple(x.shape[1:]))


def broadcast_(x: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``x`` on every rank, in place; returns ``x``."""
    if active():
        dist.broadcast(x, src=0)
    return x


def reduce_metrics(metrics: Dict) -> Dict:
    """The float scalar tensors of ``metrics`` as their means over the
    data group (one ``all_reduce``); the other entries as they are."""
    if grid().data_group is None:
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


# --- tensor parallelism: the model group -------------------------------------

def _sum_over_model(t: torch.Tensor) -> torch.Tensor:
    """The fp32 sum of ``t`` over the model group, in ``t``'s dtype."""
    buf = t.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(buf, group=grid().model_group)
    return buf.to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over_model(g)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _sum_over_model(x)

    @staticmethod
    def backward(ctx, g):
        return g


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` (the same on every rank of the model group); its gradient is
    summed over the group: each rank's shard contributes a part."""
    if grid().model_group is None:
        return x
    return _CopyToModel.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over the model group (fp32);
    the gradient of the sum reaches each part unchanged."""
    if grid().model_group is None:
        return x
    return _ReduceFromModel.apply(x)


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of the detached ``x`` over the model group."""
    if grid().model_group is None:
        return x
    buf = x.detach().to(torch.float32, copy=True).contiguous()
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=grid().model_group)
    return buf.to(x.dtype)


def gather_vocab(x: torch.Tensor) -> torch.Tensor:
    """Vocab-parallel x [..., V / model] -> [..., V] in model-rank order,
    the same bits on every rank (an fp32 ``all_reduce`` of the shards
    placed in zeros; not differentiable)."""
    g = grid()
    if g.model_group is None:
        return x
    out = x.new_zeros((g.model,) + tuple(x.shape), dtype=torch.float32)
    out[g.model_index] = x
    dist.all_reduce(out, group=g.model_group)
    return torch.cat(out.to(x.dtype).unbind(0), dim=-1)


def vocab_parallel_cross_entropy(logits: torch.Tensor,
                                 target: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of vocab-parallel logits [N, V / model] (fp32,
    this rank's slice of the vocabulary, in model-rank order) against the
    full-vocabulary ids ``target`` [N]: log sum exp - target logit from
    the row max (detached), the sum of exponentials and the target's
    logit, each one all-reduce of [N] over the model group."""
    g = grid()
    v = logits.shape[-1]
    m = max_over_model(logits.detach().amax(dim=-1))
    shifted = logits - m[:, None]
    sum_exp = reduce_from_model(shifted.exp().sum(dim=-1))
    local = target.long() - g.model_index * v
    inside = (local >= 0) & (local < v)
    picked = shifted.gather(1, local.clamp(0, v - 1)[:, None])[:, 0]
    picked = reduce_from_model(torch.where(inside, picked,
                                           torch.zeros_like(picked)))
    return (sum_exp.log() - picked).mean()


def model_parts(tensors: Mapping[str, torch.Tensor], keys: Sequence[str]
                ) -> List[Dict[str, torch.Tensor]]:
    """Every model rank's view of ``tensors``, in model-rank order: the
    entries of ``keys`` (same shapes on every rank) broadcast from each
    rank of the model group, on the CPU and bit for bit; the others this
    rank's own."""
    g = grid()
    mine = {k: v.detach() for k, v in tensors.items()}
    if g.model_group is None:
        return [mine]
    parts = [dict(mine) for _ in range(g.model)]
    for k in keys:
        for j in range(g.model):
            buf = (mine[k].clone() if j == g.model_index
                   else torch.empty_like(mine[k]))
            dist.broadcast(buf, src=g.data_index * g.model + j,
                           group=g.model_group)
            parts[j][k] = buf.cpu()
    return parts
