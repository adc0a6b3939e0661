"""Routed SwiGLU experts: routing on the device and the grouped expert
product (kernel B12).

B12 replaces no kernel of the JAX package, which has no mixture of
experts: it was added for LFM2-MoE's feed-forward (``models/hybrid.py``),
where each token's ``k`` chosen experts compute ``w_e W2_e (silu(x W1_e)
* x W3_e)``.  Its plain twin ``expert_swiglu_plain`` loops over the
experts in torch.

Routing (``route``, ``group``): sigmoid scores ``s``; the ``k`` experts
with the largest ``s + bias`` (the bias only chooses); weights ``s`` of
the chosen, over their sum + 1e-6 where ``normalize``, times ``scale``.
Granite's router (``score`` "softmax") takes the ``k`` largest logits and
a softmax over them.
The (token, slot) pairs are then ordered by expert, stably (pair order
within an expert), by a sort and a binary search on the device: no host
value, no ``nonzero`` or ``bincount``, so a CUDA graph can capture the
step.  (A cumulative sum of the one-hot [pairs, E] down its rows, the
first design, took 1 ms a decode step's layer and 10 s a b384 prefill:
that scan walks each column serially.)  ``group`` returns the order and
the per-expert offsets on the device.

B12 is CUDA C++ (``csrc/moe_swiglu.cu``, where its design and what
bounds it are set out): two launches a call, ``up`` (x rows gathered by
token, ``silu(x W1) * (x W3)`` in expert order) and ``down`` (times W2
and the routing weight, in pair order, so the sum over a token's ``k``
pairs is a reduction in a fixed order), each over a grid sized for the
worst case of its pairs so that the decode step's launches replay from a
CUDA graph.  Given a counter buffer (``MoE.routed``), the up launch also
adds the routing's counts to it (``count_routed`` on the CPU).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.nn import functional as F

from .. import _build

EPS = 1e-6
# B12's tile (rows, columns a block), as csrc/moe_swiglu.cu compiles it
TILE_ROWS, TILE_COLS = 128, 128
MAX_EXPERTS = 256


class Groups(NamedTuple):
    """(token, slot) pairs ordered by expert: ``order`` [P] int32 pair ids
    (pair p is token p // k, slot p % k), ``offsets`` [E + 1] int32 where
    each expert's pairs start."""
    order: torch.Tensor
    offsets: torch.Tensor

    @property
    def counts(self) -> torch.Tensor:
        """Each expert's pairs, [E] int32."""
        return self.offsets.diff()


def route(logits: torch.Tensor, bias: Optional[torch.Tensor], k: int,
          normalize: bool, scale: float, score: str = "sigmoid"):
    """Router logits [T, E] (fp32) -> (chosen experts [T, k] int64,
    their weights [T, k] fp32).  ``score`` "softmax": the k largest
    logits, weighted by a softmax over those k (Granite's router; no bias,
    the weights sum to 1 and ``normalize`` adds nothing)."""
    if score == "softmax":
        top = torch.topk(logits.float(), k, dim=-1)
        return top.indices, torch.softmax(top.values, dim=-1) * scale
    s = torch.sigmoid(logits.float())
    chooser = s if bias is None else s + bias.float()
    idx = torch.topk(chooser, k, dim=-1).indices
    w = s.gather(1, idx)
    if normalize:
        w = w / (w.sum(dim=-1, keepdim=True) + EPS)
    return idx, w * scale


def group(idx: torch.Tensor, num_experts: int) -> Groups:
    """Order the pairs of ``idx`` [T, k] by expert, stably, on the
    device: a stable sort of the pairs' experts, and each expert's first
    pair by a binary search of the sorted experts."""
    e = idx.reshape(-1)
    ordered, order = torch.sort(e, stable=True)
    offsets = torch.searchsorted(
        ordered, torch.arange(num_experts + 1, device=e.device),
        out_int32=True)
    return Groups(order.to(torch.int32), offsets)


def count_routed(routed: torch.Tensor, offsets: torch.Tensor) -> None:
    """Add a call's routing to the counters ``routed`` [E + 3] int32: the
    pairs of each expert, the experts with a pair, one call, the busiest
    expert's pairs (what B12's up launch adds on the card)."""
    c = offsets.diff()
    n = c.shape[0]
    routed[:n] += c
    routed[n] += (c > 0).sum(dtype=torch.int32)
    routed[n + 1] += 1
    routed[n + 2] += c.max()


def expert_swiglu_plain(x: torch.Tensor, w1: torch.Tensor,
                        w3: torch.Tensor, w2: torch.Tensor, groups: Groups,
                        weights: torch.Tensor, k: int) -> torch.Tensor:
    """Plain twin of B12: x [T, D], w1 and w3 [E, F, D], w2 [E, D, F],
    ``weights`` [T, k] fp32 -> [T, D] fp32, the weighted sum of each
    token's experts.  The hidden activation is rounded to x's dtype as the
    kernel stores it; the products accumulate in fp32."""
    t, d = x.shape
    y = torch.zeros(t * k, d, dtype=torch.float32, device=x.device)
    bounds = groups.offsets.tolist()
    w = weights.reshape(-1)
    for e, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
        if hi == lo:
            continue
        pairs = groups.order[lo:hi].long()
        xs = x[pairs // k].float()
        h = (F.silu(xs @ w1[e].float().t()) * (xs @ w3[e].float().t())
             ).to(x.dtype)
        y[pairs] = (h.float() @ w2[e].float().t()) * w[pairs, None]
    return y.view(t, k, d).sum(dim=1)


def _check(x, w1, w3, w2, groups, weights, k, routed):
    e, fw, d = w1.shape
    if x.dim() != 2 or x.shape[1] != d:
        raise ValueError(f"x must be [T, {d}], got {tuple(x.shape)}")
    if w3.shape != w1.shape or w2.shape != (e, d, fw):
        raise ValueError(f"w1, w3 must be [E, F, D] and w2 [E, D, F], got "
                         f"{tuple(w1.shape)}, {tuple(w3.shape)}, "
                         f"{tuple(w2.shape)}")
    if any(t.dtype != torch.bfloat16 for t in (x, w1, w3, w2)):
        raise TypeError(f"B12 takes bf16 x and weights, got {x.dtype}, "
                        f"{w1.dtype}, {w3.dtype}, {w2.dtype}")
    if weights.shape != (x.shape[0], k) or weights.dtype != torch.float32:
        raise ValueError(f"weights must be fp32 [T, {k}], got "
                         f"{weights.dtype} {tuple(weights.shape)}")
    if (groups.order.shape != (x.shape[0] * k,)
            or groups.offsets.shape != (e + 1,)
            or any(t.dtype != torch.int32 for t in groups)):
        raise ValueError(f"groups must be int32 order [{x.shape[0] * k}] "
                         f"and offsets [{e + 1}]")
    if routed is not None and (routed.shape != (e + 3,)
                               or routed.dtype != torch.int32):
        raise ValueError(f"routed must be int32 [{e + 3}], got "
                         f"{routed.dtype} {tuple(routed.shape)}")
    tensors = (x, w1, w3, w2, weights, *groups) + (
        () if routed is None else (routed,))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("B12's inputs must be contiguous")
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, the weights and the routing must share a device")
    if e > MAX_EXPERTS:
        raise ValueError(f"B12 takes at most {MAX_EXPERTS} experts, got {e}")
    if fw % TILE_COLS or d % TILE_COLS:
        raise ValueError(f"B12 needs D and F multiples of {TILE_COLS}, got "
                         f"D {d}, F {fw}")
    if -(-x.shape[0] * k // TILE_ROWS) + e > 65535:
        raise ValueError(f"B12 takes at most {(65535 - e) * TILE_ROWS} "
                         f"pairs a call, got {x.shape[0] * k}")


def expert_swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                  w2: torch.Tensor, groups: Groups, weights: torch.Tensor,
                  k: int, routed: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Each token's chosen experts, weighted and summed: x [T, D], w1 and
    w3 [E, F, D], w2 [E, D, F], ``groups`` from ``group`` over the [T, k]
    choices, ``weights`` [T, k] fp32 -> [T, D] fp32; the call's routing
    added to the counters ``routed`` [E + 3] int32 where given.  Kernel
    B12 for CUDA tensors, plain twin for CPU tensors."""
    if x.device.type == "cpu":
        if routed is not None:
            count_routed(routed, groups.offsets)
        return expert_swiglu_plain(x, w1, w3, w2, groups, weights, k)
    if x.device.type != "cuda":
        raise ValueError(f"expert_swiglu runs on cpu or cuda, got {x.device}")
    pairs = x.shape[0] * k
    _check(x, w1, w3, w2, groups, weights, k, routed)
    e, fw, d = w1.shape
    h = torch.empty(pairs, fw, dtype=x.dtype, device=x.device)
    y = torch.empty(pairs, d, dtype=torch.float32, device=x.device)
    lib = _build.library()
    stream = _build.stream(x.device.index)
    order, offsets = (t.data_ptr() for t in groups)
    for up, a, w0, w1_, out, n, kdim in (
            (1, x, w1, w3, h, fw, d), (0, h, w2, None, y, d, fw)):
        status = lib.mas_moe_swiglu(
            a.data_ptr(), w0.data_ptr(), None if w1_ is None else
            w1_.data_ptr(), out.data_ptr(), weights.data_ptr(), order,
            offsets, routed.data_ptr() if up and routed is not None
            else None, pairs, n, kdim, k, e, up, stream)
        _build.check(status, "moe_swiglu")
    expert_swiglu.launches += 1
    return y.view(x.shape[0], k, d).sum(dim=1)


expert_swiglu.launches = 0
