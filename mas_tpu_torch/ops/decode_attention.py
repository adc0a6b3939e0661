"""Single-token decode attention over a float KV cache (kernel B9), the
float cache and its write.

Counterpart of ``mas_tpu/ops/decode_attention.py``: ``decode_attention_
float`` is the Pallas ``_decode_kernel`` (``decode_attention(...,
impl='pallas')``), hand-written for Hopper in ``csrc/decode_quant.cu`` as
the float instance of kernel B2's template (``decode_float_kernel``: no
scales, no dequantization); ``decode_attention_float_plain`` is its plain
twin.  Both follow the Pallas kernel, not the jnp path, on where p is
rounded: p stays fp32 and only the output is rounded to q's dtype (the jnp
path rounds p to the cache dtype).  The q scale 1/8 is exact in any dtype.

The port's cache layout is [B, H, T, d] (the JAX package's is the
transposed [B, H, d, T], which suits TPU lanes), in the compute dtype,
allocated at full length with zeros beyond the prefix (``FloatCache``).
The new token is written with an in-place ``index_copy_`` at the device
position (``write_float_kv``): the JAX package writes it with a
``dynamic_update_slice`` outside any kernel, so no kernel is needed here.

The wrapper takes the plain twin only for CPU tensors; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import _build
from .quant import check_index, check_query

_NEG_INF = -1e30


@dataclass
class FloatCache:
    """One tensor's float decode cache [B, H, T, d] in the compute dtype,
    preallocated at full length and written in place."""

    data: torch.Tensor

    @classmethod
    def seeded(cls, prefix: torch.Tensor, length: int) -> "FloatCache":
        """A ``length``-position cache holding the prefill k or v [B, H, P,
        d] at [0, P) and zeros beyond (``mas_tpu/models/sampler.py``)."""
        b, h, p, d = prefix.shape
        data = torch.zeros((b, h, length, d), dtype=prefix.dtype,
                           device=prefix.device)
        data[:, :, :p] = prefix
        return cls(data)


def write_float_kv(k_cache: FloatCache, v_cache: FloatCache,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   index: torch.Tensor) -> None:
    """Write one token's k and v [B, H, d] in place at ``index`` (a
    1-element int32 tensor on the caches' device: no host sync)."""
    pos = index.to(device=k_cache.data.device, dtype=torch.long)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cache.data.index_copy_(2, pos, new[:, :, None].to(cache.data.dtype))


def decode_attention_float_plain(q, k_cache: FloatCache, v_cache: FloatCache,
                                 index: torch.Tensor):
    """q [B, H, 1, d]; positions <= index (1-element int32 tensor) are
    visible.  Returns [B, H, 1, d] in q's dtype; fp32 scores, softmax and
    sum."""
    d = q.shape[-1]
    qs = (q * (1.0 / math.sqrt(d))).float()     # scaled in q's dtype
    s = torch.matmul(qs, k_cache.data.float().transpose(-1, -2))
    kpos = torch.arange(s.shape[-1], device=q.device)
    s = s.masked_fill(kpos > index.to(q.device), _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v_cache.data.float()).to(q.dtype)


def _check(q, k_cache: FloatCache, v_cache: FloatCache, index):
    check_query(q)
    b, h, _, d = q.shape
    k, v = k_cache.data, v_cache.data
    t = k.shape[2]
    for c in (k, v):
        if (tuple(c.shape) != (b, h, t, d) or c.dtype != k.dtype
                or c.dtype not in (torch.bfloat16, torch.float32)):
            raise ValueError(f"caches must be bf16 or fp32 [{b}, {h}, T, {d}]"
                             f" of one dtype, got {c.dtype} {tuple(c.shape)}")
        if not c.is_contiguous() or c.data_ptr() % 16:
            raise ValueError("caches must be contiguous and 16-byte aligned")
        if c.device != q.device:
            raise ValueError(f"caches must be on {q.device}")
    check_index(index, q.device)


def decode_attention_float(q, k_cache: FloatCache, v_cache: FloatCache,
                           index: torch.Tensor):
    """Single-token attention over a float cache, masked to <= index; only
    positions <= index are read.

    q [B, H, 1, 64] bf16 or fp32 (any batch/head strides, contiguous last
    dim), caches contiguous bf16 or fp32 [B, H, T, 64], ``index`` a
    1-element int32 tensor on q's device.  Returns a contiguous
    [B, H, 1, 64] tensor in q's dtype.
    """
    if q.device.type == "cpu":
        return decode_attention_float_plain(q, k_cache, v_cache, index)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_float runs on cpu or cuda, got "
                         f"{q.device}")
    _check(q, k_cache, v_cache, index)
    b, h, _, d = q.shape
    out = torch.empty((b, h, 1, d), dtype=q.dtype, device=q.device)
    lib = _build.library()
    status = lib.mas_decode_float(
        q.data_ptr(), k_cache.data.data_ptr(), v_cache.data.data_ptr(),
        index.data_ptr(), out.data_ptr(), b, h, k_cache.data.shape[2],
        q.stride(0), q.stride(1), int(k_cache.data.dtype == torch.bfloat16),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "decode_float")
    decode_attention_float.launches += 1
    return out


decode_attention_float.launches = 0
