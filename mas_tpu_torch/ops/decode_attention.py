"""Single-token decode attention over a float KV cache (kernel B9), the
float cache and its write.

Counterpart of ``mas_tpu/ops/decode_attention.py``: ``decode_attention_
float`` is the Pallas ``_decode_kernel`` (``decode_attention(...,
impl='pallas')``), hand-written for Hopper in ``csrc/decode_quant.cu`` as
the float instance of kernel B2's template (``decode_float_kernel``: no
scales, no dequantization; the same split over a thread-block cluster);
``decode_attention_float_plain`` is its plain twin.  Both follow the Pallas
kernel, not the jnp path, on where p is rounded: p stays fp32 and only the
output is rounded to q's dtype (the jnp path rounds p to the cache dtype).
Both scale q by 1/sqrt(d) in q's dtype, as the JAX package's
``q * jnp.asarray(scale, q.dtype)``: the scale is rounded to q's dtype
(``q_scale``) and so is the product (exact for d 64, not for d 32 or 128).

The port's cache layout is [B, H, T, D] (the JAX package's is the
transposed [B, H, d, T], which suits TPU lanes), in the compute dtype,
allocated at full length with zeros beyond the prefix (``FloatCache``).
D is the width that holds the head dim d (``quant.decode_width``: 32, 64,
128, or a multiple of 256 taken in chunks); the columns past d stay zero,
add nothing to q . k and give output columns the kernel never writes: it
reads q's d columns and returns [B, H, 1, d].  The new token is written
with an in-place ``index_copy_`` into the first d columns at the device
position (``write_float_kv``): the JAX package writes it with a
``dynamic_update_slice`` outside any kernel, so no kernel is needed here.

Grouped-query attention: q has H heads and the caches KV heads, KV
dividing H, and query head h reads kv head h // (H / KV), as in B2
(``ops/quant.py``); the kernel reads each kv head's cache once for its
H / KV query rows.

The wrapper takes the plain twin only for CPU tensors; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import _build
from .attention import q_scale
from .quant import (cache_heads, check_index, check_query, decode_split,
                    decode_width, grouped)

_NEG_INF = -1e30


@dataclass
class FloatCache:
    """One tensor's float decode cache [B, KV, T, D] in the compute dtype
    (D = ``decode_width(d)``, columns past d zero), preallocated at full
    length and written in place."""

    data: torch.Tensor

    @classmethod
    def seeded(cls, prefix: torch.Tensor, length: int) -> "FloatCache":
        """A ``length``-position cache holding the prefill k or v [B, H, P,
        d] at [0, P) and zeros beyond (``mas_tpu/models/sampler.py``), each
        position ``decode_width(d)`` values wide."""
        b, h, p, d = prefix.shape
        data = torch.zeros((b, h, length, decode_width(d)),
                           dtype=prefix.dtype, device=prefix.device)
        data[:, :, :p, :d] = prefix
        return cls(data)


def write_float_kv(k_cache: FloatCache, v_cache: FloatCache,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   index: torch.Tensor) -> None:
    """Write one token's k and v [B, H, d] in place into the first d
    columns at ``index`` (a 1-element int32 tensor on the caches' device:
    no host sync)."""
    pos = index.to(device=k_cache.data.device, dtype=torch.long)
    d = k_new.shape[-1]
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        data = cache.data
        if data.shape[-1] != d:
            data = data[..., :d]
        data.index_copy_(2, pos, new[:, :, None].to(data.dtype))


def decode_attention_float_plain(q, k_cache: FloatCache, v_cache: FloatCache,
                                 index: torch.Tensor):
    """q [B, H, 1, d] against caches of KV heads (KV divides H; query
    head h reads kv head h // (H / KV)); positions <= index (1-element int32
    tensor) are visible; the caches' first d columns are read.  Returns
    [B, H, 1, d] in q's dtype; fp32 scores, softmax and sum."""
    b, h, _, d = q.shape
    qg = grouped(q, k_cache.data.shape[1])
    qs = (qg * q_scale(d, q.dtype)).float()   # scaled in q's dtype
    s = torch.matmul(qs, k_cache.data[..., :d].float().transpose(-1, -2))
    kpos = torch.arange(s.shape[-1], device=q.device)
    s = s.masked_fill(kpos > index.to(q.device), _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p, v_cache.data[..., :d].float())
    return out.reshape(b, h, 1, d).to(q.dtype)


def _check(q, k_cache: FloatCache, v_cache: FloatCache, index) -> int:
    """Raise unless the kernel takes q, the caches and index; returns the
    caches' kv head count."""
    check_query(q)
    b, _, _, d = q.shape
    width = decode_width(d)
    k, v = k_cache.data, v_cache.data
    kv = cache_heads(q, k)
    t = k.shape[2]
    for c in (k, v):
        if (tuple(c.shape) != (b, kv, t, width) or c.dtype != k.dtype
                or c.dtype not in (torch.bfloat16, torch.float32)):
            raise ValueError(f"caches must be bf16 or fp32 [{b}, {kv}, T, "
                             f"{width}] of one dtype, got {c.dtype} "
                             f"{tuple(c.shape)}")
        if not c.is_contiguous() or c.data_ptr() % 16:
            raise ValueError("caches must be contiguous and 16-byte aligned")
        if c.device != q.device:
            raise ValueError(f"caches must be on {q.device}")
    check_index(index, q.device)
    return kv


def decode_attention_float(q, k_cache: FloatCache, v_cache: FloatCache,
                           index: torch.Tensor):
    """Single-token attention over a float cache, masked to <= index; only
    positions <= index are read.

    q [B, H, 1, d] bf16 or fp32 (any batch/head strides, contiguous last
    dim), caches contiguous bf16 or fp32 [B, KV, T, D] with KV dividing H
    (query head h reads kv head h // (H / KV)) and D = ``decode_width(d)``,
    ``index`` a 1-element int32 tensor on q's device.  Returns a contiguous
    [B, H, 1, d] tensor in q's dtype.
    """
    if q.device.type == "cpu":
        return decode_attention_float_plain(q, k_cache, v_cache, index)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_float runs on cpu or cuda, got "
                         f"{q.device}")
    kv = _check(q, k_cache, v_cache, index)
    b, h, _, d = q.shape
    out = torch.empty((b, h, 1, d), dtype=q.dtype, device=q.device)
    lib = _build.library()
    status = lib.mas_decode_float(
        q.data_ptr(), k_cache.data.data_ptr(), v_cache.data.data_ptr(),
        index.data_ptr(), out.data_ptr(), b, kv, h // kv,
        k_cache.data.shape[2], q.stride(0), q.stride(1), decode_width(d), d,
        int(k_cache.data.dtype == torch.bfloat16),
        int(q.dtype == torch.bfloat16), decode_split(b * kv),
        q_scale(d, q.dtype), _build.stream(q.get_device()))
    _build.check(status, "decode_float")
    decode_attention_float.launches += 1
    return out


decode_attention_float.launches = 0
