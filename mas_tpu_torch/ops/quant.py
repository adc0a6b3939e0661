"""int8/int4 KV-cache quantization and the quantized decode read (kernel B2).

Counterpart of ``mas_tpu/ops/quant.py``.  Same scheme: symmetric
per-(batch, head, position) quantization over the d feature dim,

    k_q[t] = clip(round(k[t] / ks[t]), -qmax, qmax),  ks[t] = max|k[t]| / qmax
    s[t]   = (q . k_q[t]) * ks[t]          (scale folds in after the dot)
    out    = sum_t (p[t] * vs[t]) * v_q[t] (v scale folds into the probs)

with qmax 127 (int8) or 7 (int4).  The port's cache layout is its own:
values [B, H, T, d] int8, or [B, H, T, d/2] uint8 for int4 (torch has no
int4: two nibbles per byte, low nibble = even dim); scales [B, H, T] fp32.
Each position's d values are contiguous, which is what the kernel reads.

``decode_attention_quant`` launches ``csrc/decode_quant.cu`` for CUDA
tensors and takes ``decode_attention_quant_plain`` only for CPU tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import _build

_NEG_INF = -1e30
_EPS = 1e-8
HEAD_DIM = 64


def qmax_for(bits: int) -> float:
    if bits not in (4, 8):
        raise ValueError(f"cache bits must be 4 or 8, got {bits}")
    return 7.0 if bits == 4 else 127.0


@dataclass
class QuantCache:
    """One tensor's quantized decode cache, preallocated at full length and
    written in place."""

    q: torch.Tensor       # int8 [B, H, T, d] or uint8 [B, H, T, d/2]
    scale: torch.Tensor   # fp32 [B, H, T]
    bits: int

    @classmethod
    def empty(cls, batch: int, heads: int, length: int, head_dim: int,
              bits: int, device=None) -> "QuantCache":
        """Zero values and unit scales, as the JAX sampler allocates."""
        qmax_for(bits)
        shape = (batch, heads, length,
                 head_dim // 2 if bits == 4 else head_dim)
        dtype = torch.uint8 if bits == 4 else torch.int8
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.ones((batch, heads, length), dtype=torch.float32,
                              device=device), bits)

    def values(self) -> torch.Tensor:
        """Integer values as int8 [B, H, T, d] (int4 unpacked)."""
        return unpack_int4(self.q) if self.bits == 4 else self.q


def quantize_values(f: torch.Tensor, bits: int):
    """[..., d] float -> (int8 values [..., d], fp32 scales [...]), exactly
    as ``mas_tpu.ops.quant.quantize_kv`` (fp32 division, round half to
    even)."""
    qmax = qmax_for(bits)
    f = f.float()
    amax = torch.clamp_min(f.abs().amax(dim=-1, keepdim=True), _EPS)
    # divide by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which can differ in the last bit
    scale = amax / torch.full_like(amax, qmax)
    q = torch.clamp(torch.round(f / scale), -qmax, qmax).to(torch.int8)
    return q, scale[..., 0]


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 [..., d] in [-8, 7] -> uint8 [..., d/2]; low nibble = even dim."""
    x = q.to(torch.int16)
    lo = x[..., 0::2] & 0xF
    hi = x[..., 1::2] & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """uint8 [..., d/2] -> int8 [..., d], nibbles sign-extended."""
    x = p.to(torch.int16)
    lo = x & 0xF
    hi = (x >> 4) & 0xF
    both = torch.stack([lo, hi], dim=-1).flatten(-2)
    return (both - ((both & 0x8) << 1)).to(torch.int8)


def quantize_kv(kv: torch.Tensor, bits: int = 8) -> QuantCache:
    """[B, H, T, d] float -> QuantCache (values packed for int4)."""
    q, scale = quantize_values(kv, bits)
    return QuantCache(pack_int4(q) if bits == 4 else q, scale, bits)


def dequantize_kv(cache: QuantCache) -> torch.Tensor:
    return cache.values().float() * cache.scale[..., None]


def decode_attention_quant_plain(q, k_cache: QuantCache,
                                 v_cache: QuantCache, index: torch.Tensor):
    """q [B, H, 1, d]; positions <= index (1-element int32 tensor) are
    visible.  Returns [B, H, 1, d] in q's dtype; fp32 throughout."""
    d = q.shape[-1]
    s = torch.matmul(q.float() * (1.0 / math.sqrt(d)),
                     k_cache.values().float().transpose(-1, -2))
    s = s * k_cache.scale[:, :, None, :]
    kpos = torch.arange(s.shape[-1], device=q.device)
    s = s.masked_fill(kpos > index.to(q.device), _NEG_INF)
    p = torch.softmax(s, dim=-1)
    pv = p * v_cache.scale[:, :, None, :]
    return torch.matmul(pv, v_cache.values().float()).to(q.dtype)


def check_caches(k_cache: QuantCache, v_cache: QuantCache, batch: int,
                 heads: int, device, index: torch.Tensor) -> None:
    """Raise unless both caches are contiguous [batch, heads, T, 64] (int4:
    [.., 32] uint8) with fp32 [batch, heads, T] scales on ``device``, of one
    bit width, and ``index`` is a 1-element int32 tensor there."""
    if k_cache.bits != v_cache.bits:
        raise ValueError("k and v caches must share one bit width")
    width = HEAD_DIM // 2 if k_cache.bits == 4 else HEAD_DIM
    vdtype = torch.uint8 if k_cache.bits == 4 else torch.int8
    t = k_cache.q.shape[2]
    for c in (k_cache, v_cache):
        if (tuple(c.q.shape) != (batch, heads, t, width) or c.q.dtype != vdtype
                or tuple(c.scale.shape) != (batch, heads, t)
                or c.scale.dtype != torch.float32):
            raise ValueError(
                f"cache must be {vdtype} [{batch}, {heads}, T, {width}] with "
                f"fp32 [{batch}, {heads}, T] scales, got {c.q.dtype} "
                f"{tuple(c.q.shape)} / {c.scale.dtype} "
                f"{tuple(c.scale.shape)}")
        if not (c.q.is_contiguous() and c.scale.is_contiguous()):
            raise ValueError("caches must be contiguous")
        if c.q.device != device or c.scale.device != device:
            raise ValueError(f"caches must be on {device}")
    if (index.dtype != torch.int32 or index.numel() != 1
            or index.device != device):
        raise ValueError(f"index must be a 1-element int32 tensor on "
                         f"{device}")


def _check(q, k_cache, v_cache, index):
    b, h, one, d = q.shape
    if one != 1 or d != HEAD_DIM:
        raise ValueError(f"q must be [B, H, 1, {HEAD_DIM}], got "
                         f"{tuple(q.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bf16 or fp32, got {q.dtype}")
    if q.stride(-1) != 1:
        raise ValueError("q needs a contiguous last dim")
    check_caches(k_cache, v_cache, b, h, q.device, index)


def decode_attention_quant(q, k_cache: QuantCache, v_cache: QuantCache,
                           index: torch.Tensor):
    """Single-token attention over quantized caches, masked to <= index.

    q [B, H, 1, 64] (any batch/head strides, contiguous last dim), caches
    as ``QuantCache``, ``index`` a 1-element int32 tensor on q's device.
    Returns a contiguous [B, H, 1, 64] tensor in q's dtype.
    """
    if q.device.type == "cpu":
        return decode_attention_quant_plain(q, k_cache, v_cache, index)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_quant runs on cpu or cuda, got "
                         f"{q.device}")
    _check(q, k_cache, v_cache, index)
    b, h, _, d = q.shape
    out = torch.empty((b, h, 1, d), dtype=q.dtype, device=q.device)
    lib = _build.library()
    status = lib.mas_decode_quant(
        q.data_ptr(), k_cache.q.data_ptr(), k_cache.scale.data_ptr(),
        v_cache.q.data_ptr(), v_cache.scale.data_ptr(), index.data_ptr(),
        out.data_ptr(), b, h, k_cache.q.shape[2], q.stride(0), q.stride(1),
        k_cache.bits, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "decode_quant")
    decode_attention_quant.launches += 1
    return out


decode_attention_quant.launches = 0
