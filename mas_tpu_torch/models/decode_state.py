"""One attention layer's decode state, and the one place that chooses its
kind (``kv_state``).

A state is allocated once at full length, seeded with the prefill's k/v
and written in place by every decode step: ``write(k, v, index)`` stores
the token's k/v at ``index``, ``read(q, index)`` attends over positions
<= index, and ``tensors()`` are the buffers that the step writes and
reads, whose addresses a CUDA graph bakes in (``models/decode_graph.py``
keys on them; the hybrid block's ``ConvState`` and the Granite block's
``MambaState`` have them too).  The kinds:
  * float (``kv_cache_dtype: "compute"``): an in-place ``index_copy_``,
    then B9 (``ops/decode_attention.py``);
  * int8/int4 lane caches (``kv_cache_layout`` "lane" or "lane_aliased",
    scales in ``kv_scale_dtype``): B3 (``ops/decode_cache.py``), then B2
    (``ops/quant.py``);
  * int8/int4 packed cache (``kv_cache_layout: "packed"``): B10, then B2
    over strided views of the packed buffer (``ops/decode_cache.py``).
CPU tensors take the kernels' plain twins.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import decode_attention, decode_cache, quant
from ..utils.config import TransformerConfig


@dataclass
class FloatState:
    """k and v float caches [B, KV, T, D] in the compute dtype."""
    k: decode_attention.FloatCache
    v: decode_attention.FloatCache

    def write(self, k, v, index):
        decode_attention.write_float_kv(self.k, self.v, k, v, index)

    def read(self, q, index):
        return decode_attention.decode_attention_float(q, self.k, self.v,
                                                       index)

    def tensors(self):
        return self.k.data, self.v.data


@dataclass
class LaneState:
    """k and v quantized caches, each with its own values and scales."""
    k: quant.QuantCache
    v: quant.QuantCache

    def write(self, k, v, index):
        decode_cache.write_quant_kv(self.k, self.v, k, v, index)

    def read(self, q, index):
        return quant.decode_attention_quant(q, self.k, self.v, index)

    def tensors(self):
        return self.k.q, self.k.scale, self.v.q, self.v.scale


@dataclass
class PackedState:
    """k and v quantized into one buffer, their scales into one tensor."""
    cache: decode_cache.PackedQuantCache

    def write(self, k, v, index):
        decode_cache.write_packed_kv(self.cache, k, v, index)

    def read(self, q, index):
        return decode_cache.decode_attention_packed(q, self.cache, index)

    def tensors(self):
        return self.cache.kv, self.cache.scale


@dataclass
class MambaState:
    """A Mamba2 layer's decode state (``models/hybrid.py::Mamba2``): the
    SSM state [B, H, P, N] fp32, which each step advances in place
    (``ops/ssm.py::ssm_update``, B14), and the conv's ring of its last K
    inputs [B, K, channels] fp32, input of position p in slot p % K.  Both
    are the prefill's own buffers, taken over without a copy: at the
    serving batch the states are GBs a layer."""
    ssm: torch.Tensor
    conv: torch.Tensor

    def tensors(self):
        return self.ssm, self.conv


def kv_state(cfg: TransformerConfig, k: torch.Tensor, v: torch.Tensor,
             batch: int):
    """The state of ``cfg``'s kind, ``total_length`` positions long,
    seeded with one layer's prefill k, v [B, KV, prefix, hd]."""
    total = cfg.total_length
    if cfg.kv_cache_dtype == "compute":
        return FloatState(*(decode_attention.FloatCache.seeded(t, total)
                            for t in (k, v)))
    bits = 4 if cfg.kv_cache_dtype == "int4" else 8
    if cfg.kv_cache_layout == "packed":
        return PackedState(decode_cache.seed_packed_cache(k, v, total, bits))
    scale_dtype = (torch.bfloat16 if cfg.kv_scale_dtype == "bfloat16"
                   else torch.float32)
    lane = []
    for t in (k, v):
        c = quant.QuantCache.empty(batch, t.shape[1], total, cfg.head_dim,
                                   bits, t.device, scale_dtype)
        seeded = quant.quantize_kv(t, bits, scale_dtype)
        c.q[:, :, :t.shape[2]] = seeded.q
        c.scale[:, :, :t.shape[2]] = seeded.scale
        lane.append(c)
    return LaneState(*lane)
