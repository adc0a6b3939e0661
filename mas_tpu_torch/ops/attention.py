"""Prefix-bidirectional causal attention: forward (kernel B1), backward
(kernel B6), and ``FlashAttentionFunction``, which joins them for autograd.

Counterpart of ``mas_tpu/ops/attention.py``: ``flash_attention`` is the
forward of the Pallas flash kernel (``_fwd_kernel``), hand-written for
Hopper in ``csrc/flash_fwd.cu``; ``prefix_causal_attention_plain`` is the
plain twin (counterpart of ``prefix_causal_attention_jnp``), which also
returns the logsumexp the kernel writes for the backward pass.
``flash_attention_bwd`` is the backward (``_bwd_dkv_kernel`` and
``_bwd_dq_kernel``), hand-written in ``csrc/flash_bwd.cu``;
``prefix_causal_attention_bwd_plain`` is its plain twin.

Mask: row i sees keys [0, bound) with bound = prefix for i < prefix, else
i + 1 — causal, and bidirectional inside the text+seg prefix.  The
reference's PB-relax max shift is a per-row constant that softmax cancels,
so both versions compute the plain masked softmax with fp32 statistics.

Head dims: the kernels are instantiated for d = 64, 128 and 256, and
take any multiple of 256 above in column passes (more than 256
accumulator columns do not fit a warp's registers): each pass computes
128 output columns, with the scores summed over the whole head dim in
chunks of 256 staged through shared memory.  For any other d the wrappers
zero-pad q, k, v (and out, dO) to the next width (``kernel_head_dim``) and
drop the extra output columns; this is exact: zero columns add nothing to
q . k, the scale stays 1/sqrt(d) of the true d, and the output and
gradient columns they produce are dropped.  Any T: both kernels take a
ragged last tile.

The wrapper takes the plain twin only for CPU tensors; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.nn import functional as F

from .. import _build

_NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128, 256)   # the head dims B1 and B6 are built for


@functools.lru_cache(maxsize=None)
def q_scale(d: int, dtype: torch.dtype) -> float:
    """1 / sqrt(d) rounded to ``dtype``, as ``jnp.asarray(scale, dtype)``."""
    return float(torch.tensor(1.0 / math.sqrt(d), dtype=dtype))


def kernel_head_dim(d: int) -> int:
    """The head dim B1/B6 run at for d: 64, 128 or 256, or above 256 the
    least multiple of 256 >= d (taken in column passes)."""
    if d < 1:
        raise ValueError(f"head_dim must be >= 1, got {d}")
    top = KERNEL_HEAD_DIMS[-1]
    if d > top:
        return -(-d // top) * top
    return next(w for w in KERNEL_HEAD_DIMS if d <= w)


def pad_head_dim(x: torch.Tensor, width: int) -> torch.Tensor:
    """x [..., d] with zero columns appended up to ``width`` (a new tensor),
    or x itself when d == width."""
    d = x.shape[-1]
    return x if d == width else F.pad(x, (0, width - d))


def prefix_causal_attention_plain(q, k, v, prefix_length: int, scale=None):
    """q, k, v [B, H, T, d] -> (out [B, H, T, d] in q's dtype,
    lse [B, H, T] fp32); fp32 scores and softmax.  q is scaled in its own
    dtype, as the Pallas kernel's q * asarray(scale, q.dtype); ``scale``
    defaults to 1/sqrt(d) (the padded route passes the true d's)."""
    d = q.shape[-1]
    t = q.shape[2]
    scale = q_scale(d, q.dtype) if scale is None else scale
    s = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
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
    padded = kernel_head_dim(q.shape[-1]) != q.shape[-1]
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention takes bf16 or fp32 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last dim")
    if not padded:      # padded copies are contiguous and aligned
        _check_rows(q.dtype, q=q, k=k, v=v)


def _rows_aligned(t) -> bool:
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])


def _check_rows(dtype, **tensors):
    """The bf16 kernels copy rows in 16-byte pieces (cp.async): every
    (b, h, t) stride must be a multiple of 8 elements and the data 16-byte
    aligned.  Views into the fused qkv projection are; others raise."""
    if dtype != torch.bfloat16:
        return
    for name, t in tensors.items():
        if not _rows_aligned(t):
            raise ValueError(
                f"{name}: the bf16 kernel needs (b, h, t) strides that are "
                f"multiples of 8 and 16-byte aligned data, got strides "
                f"{tuple(t.stride())} at address {t.data_ptr():#x}")


def flash_attention(q, k, v, prefix_length: int):
    """Fused prefix-bidirectional causal attention forward.

    q, k, v [B, H, T, d] bf16 or fp32, any strides with a contiguous last
    dim (views into the fused qkv projection need no copy at d 64, 128 and
    multiples of 256; other d are zero-padded).  Returns (out [B, H, T,
    d] in q's dtype, lse [B, H, T] fp32).  On CUDA, ``out`` is a view whose
    memory is laid out [B, T, H, d'] (d' = ``kernel_head_dim(d)``), so
    merging the heads back into [B, T, H * d] costs no copy at those d.
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
    width = kernel_head_dim(d)
    q, k, v = (pad_head_dim(x, width) for x in (q, k, v))
    out = torch.empty((b, t, h, width), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    lib = _build.library()
    status = lib.mas_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), strides, b, h, t, int(prefix_length), width,
        q_scale(d, q.dtype), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "flash_fwd")
    flash_attention.launches += 1
    return (out if width == d else out[..., :d]), lse


flash_attention.launches = 0


def split_qkv(qkv: torch.Tensor):
    """[B, T, 3, H, d] fused projection -> q, k, v views [B, H, T, d]."""
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


def prefix_causal_attention_bwd_plain(q, k, v, out, lse, do,
                                      prefix_length: int, scale=None):
    """Plain twin of B6: the backward from the saved (out, lse) in fp32 ->
    (dq, dk, dv) [B, H, T, d] in q's dtype.  ``scale`` defaults to
    1/sqrt(d), in fp32 as the Pallas kernels."""
    d = q.shape[-1]
    t = q.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qf, kf, vf = q.float(), k.float(), v.float()
    gf = do.float()
    s = torch.matmul(qf * scale, kf.transpose(-1, -2))
    pos = torch.arange(t, device=q.device)
    qpos, kpos = pos[:, None], pos[None, :]
    mask = (kpos <= qpos) | ((qpos < prefix_length) & (kpos < prefix_length))
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    delta = (gf * out.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _check_bwd(q, k, v, out, lse, do):
    _check(q, k, v)
    b, h, t, _ = q.shape
    for name, x in (("out", out), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must be a {q.dtype} {tuple(q.shape)} "
                             f"tensor on {q.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last dim")
    if kernel_head_dim(q.shape[-1]) == q.shape[-1]:
        _check_rows(q.dtype, out=out, do=do)
    if (tuple(lse.shape) != (b, h, t) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse must be a contiguous fp32 [{b}, {h}, {t}] "
                         f"tensor on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")


def flash_attention_bwd(q, k, v, out, lse, do, prefix_length: int):
    """Backward of ``flash_attention`` from its saved (out, lse).

    q, k, v, out, do [B, H, T, d] bf16 or fp32 (zero-padded to
    ``kernel_head_dim(d)``, as in ``flash_attention``), any T, any
    strides with a contiguous last dim; lse [B, H, T] fp32.  Returns dqkv
    [B, T, 3, H, d] in q's dtype (dq, dk, dv along dim 2), the gradient of
    a fused qkv projection's output (a view of a [B, T, 3, H, d'] buffer
    for padded d).  Kernel B6 for CUDA tensors, plain twin for CPU
    tensors."""
    if q.device.type == "cpu":
        grads = prefix_causal_attention_bwd_plain(q, k, v, out, lse, do,
                                                  prefix_length)
        return torch.stack([g.transpose(1, 2) for g in grads], dim=2)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cpu or cuda, got "
                         f"{q.device}")
    _check_bwd(q, k, v, out, lse, do)
    if prefix_length < 0:
        raise ValueError(f"prefix_length must be >= 0, got {prefix_length}")
    b, h, t, d = q.shape
    width = kernel_head_dim(d)
    q, k, v, out, do = (pad_head_dim(x, width) for x in (q, k, v, out, do))
    dqkv = torch.empty((b, t, 3, h, width), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 15)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        *do.stride()[:3])
    lib = _build.library()
    status = lib.mas_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(),
        strides, b, h, t, int(prefix_length), width, 1.0 / math.sqrt(d),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "flash_bwd")
    flash_attention_bwd.launches += 1
    return dqkv if width == d else dqkv[..., :d]


flash_attention_bwd.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """Attention over a fused projection with a gradient: B1 forward, B6
    backward from the (out, lse) B1 wrote (their plain twins on CPU).

    The kernels fill outputs made with ``torch.empty``, which carry no
    ``grad_fn``: called bare, ``flash_attention`` cuts the autograd graph on
    the card.  Every differentiable use goes through this Function.

    ``apply(qkv, prefix_length)``: qkv [B, T, 3, H, d] -> out [B, H, T, d]
    (laid out [B, T, H, d] on CUDA); the gradient of qkv is B6's buffer."""

    @staticmethod
    def forward(ctx, qkv, prefix_length: int):
        out, lse = flash_attention(*split_qkv(qkv), prefix_length)
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(qkv, out, lse)
        ctx.prefix_length = prefix_length
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, out, lse = ctx.saved_tensors
        if do.stride(-1) != 1 or not _rows_aligned(do):
            do = do.clone(memory_format=torch.contiguous_format)
        dqkv = flash_attention_bwd(*split_qkv(qkv), out, lse, do,
                                   ctx.prefix_length)
        return dqkv, None
