"""Fused quantize-and-write of one token into the decode caches: kernel B3
for the lane caches and kernel B10 for the packed cache; the packed cache
and its read through kernel B2.

B3 replaces ``mas_tpu/ops/decode_cache.py::_lane_write_kernel`` (public
``update_quant_caches_aliased``): one launch quantizes the new token's k
and v (per-position amax over d, scale, round half to even, clip —
``mas_tpu/ops/quant.py:60-66``) and stores values and scales at ``index``
of the two lane caches (``ops/quant.py::QuantCache``).

B10 replaces ``mas_tpu/ops/decode_cache.py::_write_kernel`` (public
``update_packed_cache``): the same quantization, stored into the packed
cache (``PackedQuantCache``), where one layer's k and v share one buffer,
values [B, H, T, 2d] int8 (k in [..., :d], v in [..., d:]) or, for int4,
[B, H, T, d] uint8 (k's d/2 bytes of nibbles, then v's), and both scales
share one fp32 [2, B, H, T] tensor (k at [0], v at [1]).  The TPU kernel
read, modified and wrote back the 8- or 64-row block holding ``index``
because TPU memory tiling allows no narrower copy; on the card the
kernel stores the one position directly.

What bounds both on the H100: nothing but launch latency.  A call moves
B * H * (2 * d + 8) bytes (about 260 KB at the serving batch) and does
one small reduction over d = 64 per row.

What the design does about it: one Triton program per block of 16 (b, h)
rows handles both k and v, so the write is one launch per layer and step.
Both kernels share ``_quantize_store``; they differ only in where values
and scales go.  The division is ``tl.div_rn`` (IEEE round-to-nearest, as
torch and XLA divide) and the rounding ``rint``, so the stored integers
equal the plain twins' bit for bit, and B10's equal B3's.

The caches are written IN PLACE: they are preallocated at full length by
the sampler and never copied.  The JAX functions return new arrays.

The packed cache is read by B2 (``ops/quant.py::decode_attention_quant``)
through strided views of its k and v halves (``PackedQuantCache.views``):
the positions of one half lie 2d (int8) or d (int4) bytes apart, which is
the kernel's ``pos_stride``.  The JAX package reads it with jnp
(``decode_attention_packed``); the port reads it in place, with the bytes
of the lane read and no dequantized copy.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import quant
from .quant import (HEAD_DIM, QuantCache, check_caches, pack_int4, qmax_for,
                    quantize_values)

tl = None         # triton.language, bound on first launch
libdevice = None  # triton's libdevice, bound on first launch
_ROWS = 16        # (b, h) rows per program
_JIT = {}


def _quantize_store(src_ptr, s_sb, s_sh, q_ptr, sc_ptr, rows, rmask, heads,
                    t_len, idx, BITS: tl.constexpr, D: tl.constexpr,
                    QPOS: tl.constexpr):
    """Quantize rows [R, D] of src (row r = b * heads + h) and store them at
    position idx of the [rows, T] values QPOS bytes apart (D int8 values or
    D/2 bytes of int4 nibbles each) and of the [rows, T] scales."""
    b = rows // heads
    h = rows % heads
    src = src_ptr + b.to(tl.int64) * s_sb + h.to(tl.int64) * s_sh
    dst = rows.to(tl.int64) * t_len + idx
    if BITS == 8:
        QMAX = 127.0
        cols = tl.arange(0, D)
        f = tl.load(src[:, None] + cols[None, :], mask=rmask[:, None],
                    other=0.0).to(tl.float32)
        amax = tl.max(tl.abs(f), axis=1)
        scale = tl.div_rn(tl.maximum(amax, 1e-8),
                          tl.full(amax.shape, QMAX, tl.float32))
        qv = libdevice.rint(tl.div_rn(f, scale[:, None]))
        qv = tl.minimum(tl.maximum(qv, -QMAX), QMAX)
        tl.store(q_ptr + dst[:, None] * QPOS + cols[None, :], qv.to(tl.int8),
                 mask=rmask[:, None])
    else:
        QMAX = 7.0
        half = tl.arange(0, D // 2)
        fe = tl.load(src[:, None] + 2 * half[None, :], mask=rmask[:, None],
                     other=0.0).to(tl.float32)
        fo = tl.load(src[:, None] + 2 * half[None, :] + 1,
                     mask=rmask[:, None], other=0.0).to(tl.float32)
        amax = tl.maximum(tl.max(tl.abs(fe), axis=1),
                          tl.max(tl.abs(fo), axis=1))
        scale = tl.div_rn(tl.maximum(amax, 1e-8),
                          tl.full(amax.shape, QMAX, tl.float32))
        qe = libdevice.rint(tl.div_rn(fe, scale[:, None]))
        qo = libdevice.rint(tl.div_rn(fo, scale[:, None]))
        qe = tl.minimum(tl.maximum(qe, -QMAX), QMAX).to(tl.int32)
        qo = tl.minimum(tl.maximum(qo, -QMAX), QMAX).to(tl.int32)
        byte = (qe & 0xF) | ((qo & 0xF) << 4)
        tl.store(q_ptr + dst[:, None] * QPOS + half[None, :],
                 byte.to(tl.uint8), mask=rmask[:, None])
    tl.store(sc_ptr + dst, scale, mask=rmask)


def _write_kernel(k_ptr, k_sb, k_sh, v_ptr, v_sb, v_sh, kq_ptr, ks_ptr,
                  vq_ptr, vs_ptr, idx_ptr, n_rows, heads, t_len,
                  BITS: tl.constexpr, D: tl.constexpr, W: tl.constexpr,
                  R: tl.constexpr):
    """B3: k and v into two lane caches, W bytes per position."""
    rows = tl.program_id(0) * R + tl.arange(0, R)
    rmask = rows < n_rows
    idx = tl.load(idx_ptr).to(tl.int64)
    _quantize_store(k_ptr, k_sb, k_sh, kq_ptr, ks_ptr, rows, rmask, heads,
                    t_len, idx, BITS, D, W)
    _quantize_store(v_ptr, v_sb, v_sh, vq_ptr, vs_ptr, rows, rmask, heads,
                    t_len, idx, BITS, D, W)


def _packed_write_kernel(k_ptr, k_sb, k_sh, v_ptr, v_sb, v_sh, kv_ptr,
                         ks_ptr, vs_ptr, idx_ptr, n_rows, heads, t_len,
                         BITS: tl.constexpr, D: tl.constexpr, W: tl.constexpr,
                         R: tl.constexpr):
    """B10: k at byte 0 and v at byte W of each 2W-byte packed position."""
    rows = tl.program_id(0) * R + tl.arange(0, R)
    rmask = rows < n_rows
    idx = tl.load(idx_ptr).to(tl.int64)
    _quantize_store(k_ptr, k_sb, k_sh, kv_ptr, ks_ptr, rows, rmask, heads,
                    t_len, idx, BITS, D, 2 * W)
    _quantize_store(v_ptr, v_sb, v_sh, kv_ptr + W, vs_ptr, rows, rmask, heads,
                    t_len, idx, BITS, D, 2 * W)


def _kernels():
    """Import triton and JIT-wrap the kernels on first launch (the CPU tests
    import this module where triton does not exist)."""
    global tl, libdevice
    if not _JIT:
        import triton
        import triton.language as language
        from triton.language.extra import libdevice as ld

        tl, libdevice = language, ld
        # the write kernels call _quantize_store by its global name, so the
        # global must be the JIT function by the time they compile
        globals()["_quantize_store"] = triton.jit(_quantize_store)
        _JIT["write"] = triton.jit(_write_kernel)
        _JIT["packed"] = triton.jit(_packed_write_kernel)
    return _JIT


def _check_new(k_new, v_new):
    b, h, d = k_new.shape
    if d != HEAD_DIM or tuple(v_new.shape) != (b, h, d):
        raise ValueError(f"k_new and v_new must be [B, H, {HEAD_DIM}], got "
                         f"{tuple(k_new.shape)}, {tuple(v_new.shape)}")
    for t in (k_new, v_new):
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"new k/v must be bf16 or fp32, got {t.dtype}")
        if t.stride(-1) != 1 or t.device != k_new.device:
            raise ValueError("new k/v need a contiguous last dim on one "
                             "device")


def _launch(kernel: str, k_new, v_new, caches, index, bits, t_len, width):
    jit = _kernels()
    b, h, d = k_new.shape
    n_rows = b * h
    grid = ((n_rows + _ROWS - 1) // _ROWS,)
    # Triton launches on the current stream and raises if a launch fails
    with torch.cuda.device(k_new.device):
        jit[kernel][grid](
            k_new, k_new.stride(0), k_new.stride(1),
            v_new, v_new.stride(0), v_new.stride(1), *caches, index,
            n_rows, h, t_len, BITS=bits, D=d, W=width, R=_ROWS, num_warps=4)


# --- B3: the lane caches ----------------------------------------------------

def write_quant_kv_plain(k_cache: QuantCache, v_cache: QuantCache,
                         k_new: torch.Tensor, v_new: torch.Tensor,
                         index: torch.Tensor) -> None:
    """Plain twin: quantize k_new/v_new [B, H, d] and write them in place at
    position ``index`` (1-element int32 tensor) of the caches."""
    pos = index.to(device=k_cache.q.device, dtype=torch.long)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        q, scale = quantize_values(new, cache.bits)
        if cache.bits == 4:
            q = pack_int4(q)
        cache.q.index_copy_(2, pos, q[:, :, None])
        cache.scale.index_copy_(2, pos, scale[:, :, None])


def _check(k_cache, v_cache, k_new, v_new, index, stride=None) -> None:
    """Raise unless the new k/v and the caches are what the write kernels
    take: positions ``stride`` bytes apart (default: contiguous caches)."""
    _check_new(k_new, v_new)
    b, h, _ = k_new.shape
    stride = stride or k_cache.q.shape[3]
    if check_caches(k_cache, v_cache, b, h, k_new.device, index) != stride:
        raise ValueError(f"the write kernels need cache positions {stride} "
                         "bytes apart")


def write_quant_kv(k_cache: QuantCache, v_cache: QuantCache,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   index: torch.Tensor) -> None:
    """Quantize one token's k and v ([B, H, 64], any batch/head strides)
    and write values and scales in place at ``index`` — a 1-element int32
    tensor on the same device, so no host value of the position is read."""
    if k_new.device.type == "cpu":
        write_quant_kv_plain(k_cache, v_cache, k_new, v_new, index)
        return
    if k_new.device.type != "cuda":
        raise ValueError(f"write_quant_kv runs on cpu or cuda, got "
                         f"{k_new.device}")
    _check(k_cache, v_cache, k_new, v_new, index)
    _launch("write", k_new, v_new,
            (k_cache.q, k_cache.scale, v_cache.q, v_cache.scale), index,
            k_cache.bits, k_cache.q.shape[2], k_cache.q.shape[3])
    write_quant_kv.launches += 1


write_quant_kv.launches = 0


# --- B10: the packed cache --------------------------------------------------

@dataclass
class PackedQuantCache:
    """One layer's quantized k and v decode cache in one buffer,
    preallocated at full length and written in place."""

    kv: torch.Tensor      # int8 [B, H, T, 2d] or uint8 [B, H, T, d] (int4)
    scale: torch.Tensor   # fp32 [2, B, H, T]: [0] k scales, [1] v scales
    bits: int

    @classmethod
    def empty(cls, batch: int, heads: int, length: int, head_dim: int,
              bits: int, device=None) -> "PackedQuantCache":
        """Zero values and unit scales, as ``seed_packed_cache`` of the JAX
        package leaves the unwritten positions."""
        qmax_for(bits)
        width = 2 * (head_dim // 2 if bits == 4 else head_dim)
        dtype = torch.uint8 if bits == 4 else torch.int8
        return cls(torch.zeros((batch, heads, length, width), dtype=dtype,
                               device=device),
                   torch.ones((2, batch, heads, length), dtype=torch.float32,
                              device=device), bits)

    def views(self):
        """(k, v) ``QuantCache`` views of the two halves, positions
        ``kv.shape[-1]`` bytes apart; nothing is copied."""
        w = self.kv.shape[-1] // 2
        return (QuantCache(self.kv[..., :w], self.scale[0], self.bits),
                QuantCache(self.kv[..., w:], self.scale[1], self.bits))


def seed_packed_cache(k: torch.Tensor, v: torch.Tensor, total: int,
                      bits: int) -> PackedQuantCache:
    """Prefill k/v [B, H, prefix, d] float -> a ``total``-length packed
    cache with the prefix quantized in place, zero values and unit scales
    beyond it (``mas_tpu/ops/decode_cache.py::seed_packed_cache``)."""
    b, h, prefix, d = k.shape
    cache = PackedQuantCache.empty(b, h, total, d, bits, k.device)
    vals, scales = [], []
    for t in (k, v):
        q, s = quantize_values(t, bits)
        vals.append(pack_int4(q) if bits == 4 else q)
        scales.append(s)
    cache.kv[:, :, :prefix] = torch.cat(vals, dim=-1)
    cache.scale[:, :, :, :prefix] = torch.stack(scales)
    return cache


def write_packed_kv_plain(cache: PackedQuantCache, k_new: torch.Tensor,
                          v_new: torch.Tensor, index: torch.Tensor) -> None:
    """Plain twin of B10: quantize k_new/v_new [B, H, d] and write values
    and scales in place at position ``index`` of the packed cache."""
    pos = index.to(device=cache.kv.device, dtype=torch.long)
    vals, scales = [], []
    for new in (k_new, v_new):
        q, s = quantize_values(new, cache.bits)
        vals.append(pack_int4(q) if cache.bits == 4 else q)
        scales.append(s)
    cache.kv.index_copy_(2, pos, torch.cat(vals, dim=-1)[:, :, None])
    cache.scale.index_copy_(3, pos, torch.stack(scales)[..., None])


def write_packed_kv(cache: PackedQuantCache, k_new: torch.Tensor,
                    v_new: torch.Tensor, index: torch.Tensor) -> None:
    """Quantize one token's k and v ([B, H, 64], any batch/head strides)
    and write values and both scales in place at ``index`` (1-element int32
    device tensor) of the packed cache.  Kernel B10 for CUDA tensors, plain
    twin for CPU tensors."""
    if k_new.device.type == "cpu":
        write_packed_kv_plain(cache, k_new, v_new, index)
        return
    if k_new.device.type != "cuda":
        raise ValueError(f"write_packed_kv runs on cpu or cuda, got "
                         f"{k_new.device}")
    _check(*cache.views(), k_new, v_new, index, cache.kv.shape[3])
    _launch("packed", k_new, v_new, (cache.kv, cache.scale[0],
                                     cache.scale[1]),
            index, cache.bits, cache.kv.shape[2], cache.kv.shape[3] // 2)
    write_packed_kv.launches += 1


write_packed_kv.launches = 0


def decode_attention_packed_plain(q, cache: PackedQuantCache,
                                  index: torch.Tensor):
    """Plain twin of the packed read (``mas_tpu/ops/decode_cache.py::
    decode_attention_packed``): q [B, H, 1, d] -> [B, H, 1, d] in q's
    dtype, fp32 throughout."""
    return quant.decode_attention_quant_plain(q, *cache.views(), index)


def decode_attention_packed(q, cache: PackedQuantCache, index: torch.Tensor):
    """Single-token attention over the packed cache, masked to <= index:
    kernel B2 over the in-place views of its k and v halves (the plain twin
    for CPU tensors)."""
    return quant.decode_attention_quant(q, *cache.views(), index)
