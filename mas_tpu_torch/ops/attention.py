"""Prefix-bidirectional causal attention forward (kernel B1).

Counterpart of ``mas_tpu/ops/attention.py``: ``flash_attention`` is the
forward of the Pallas flash kernel (``_fwd_kernel``), hand-written for
Hopper in ``csrc/flash_fwd.cu``; ``prefix_causal_attention_plain`` is the
plain twin (counterpart of ``prefix_causal_attention_jnp``), which also
returns the logsumexp the kernel writes for a later backward pass.

Mask: row i sees keys [0, bound) with bound = prefix for i < prefix, else
i + 1 — causal, and bidirectional inside the text+seg prefix.  The
reference's PB-relax max shift is a per-row constant that softmax cancels,
so both versions compute the plain masked softmax with fp32 statistics.

The wrapper takes the plain twin only for CPU tensors; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

_NEG_INF = -1e30
HEAD_DIM = 64


def prefix_causal_attention_plain(q, k, v, prefix_length: int):
    """q, k, v [B, H, T, d] -> (out [B, H, T, d] in q's dtype,
    lse [B, H, T] fp32); fp32 scores and softmax."""
    d = q.shape[-1]
    t = q.shape[2]
    s = torch.matmul(q.float() * (1.0 / math.sqrt(d)),
                     k.float().transpose(-1, -2))
    pos = torch.arange(t, device=q.device)
    qpos, kpos = pos[:, None], pos[None, :]
    mask = (kpos <= qpos) | ((qpos < prefix_length) & (kpos < prefix_length))
    s = s.masked_fill(~mask, _NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return torch.matmul(p, v.float()).to(q.dtype), lse


def _check(q, k, v):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q, k, v must share one [B, H, T, d] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head_dim "
                         f"{HEAD_DIM}, got {q.shape[-1]}")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention takes bf16 or fp32 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last dim")


def flash_attention(q, k, v, prefix_length: int):
    """Fused prefix-bidirectional causal attention forward.

    q, k, v [B, H, T, 64] bf16 or fp32, any strides with a contiguous last
    dim (views into the fused qkv projection need no copy).  Returns
    (out [B, H, T, 64] in q's dtype, lse [B, H, T] fp32).  On CUDA, ``out``
    is a view whose memory is laid out [B, T, H, 64], so merging the heads
    back into [B, T, H * 64] costs no copy.
    """
    if q.device.type == "cpu":
        return prefix_causal_attention_plain(q, k, v, prefix_length)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, got "
                         f"{q.device}")
    _check(q, k, v)
    b, h, t, d = q.shape
    if prefix_length < 0:
        raise ValueError(f"prefix_length must be >= 0, got {prefix_length}")
    out = torch.empty((b, t, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    lib = _build.library()
    status = lib.mas_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), strides, b, h, t, int(prefix_length),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "flash_fwd")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0
