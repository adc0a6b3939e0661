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
values [B, H, T, 2D] int8 (k in [..., :D], v in [..., D:]) or, for int4,
[B, H, T, D] uint8 (k's D/2 bytes of nibbles, then v's), and both scales
share one fp32 [2, B, H, T] tensor (k at [0], v at [1]).  D is the decode
kernels' instance that holds the head dim d (``quant.decode_width``); the
columns past d stay zero.  The TPU kernel read, modified and wrote back the
8- or 64-row block holding ``index`` because TPU memory tiling allows no
narrower copy; on the card the kernel stores the one position directly.

Both are one CUDA C++ template, ``csrc/kv_write.cu`` (``kv_write_lane_
kernel``, ``kv_write_packed_kernel``): one warp per (b, h) row for k and
v, a shuffle reduction for the amax, ``__fdiv_rn`` and ``rintf``, so the
stored bits equal the plain twins' (``write_quant_kv_plain``,
``write_packed_kv_plain``), and B10's halves equal B3's caches.  What bounds
it is the launch: a call moves ~130 KB at the serving batch.  So the host
path is lean: ctypes into the library ``_build.py`` builds, the caches'
layouts checked once and kept (``QuantCache.layout``), and each call checks
only the new k/v and the index tensor.  The launch shape depends on B * H
only and the position is read on the device, so a CUDA graph can hold it.

The caches are written IN PLACE: they are preallocated at full length by
the sampler and never copied.  The JAX functions return new arrays.

The packed cache is read by B2 (``ops/quant.py::decode_attention_quant``)
through strided views of its k and v halves (``PackedQuantCache.views``,
made once and kept): the positions of one half lie 2D (int8) or D (int4)
bytes apart, which is the kernel's ``pos_stride``.  The JAX package reads
it with jnp (``decode_attention_packed``); the port reads it in place, with
the bytes of the lane read and no dequantized copy.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .. import _build
from . import quant
from .quant import (QuantCache, cache_width, check_caches, decode_width,
                    pack_int4, pad_values, pair_stride, qmax_for,
                    quantize_values)


_NEW_DTYPES = (torch.bfloat16, torch.float32)


def _check_new(k_new, v_new):
    shape = k_new.shape
    if len(shape) != 3 or v_new.shape != shape:
        raise ValueError(f"k_new and v_new must be [B, H, d] of one shape, "
                         f"got {tuple(k_new.shape)}, {tuple(v_new.shape)}")
    for t in (k_new, v_new):
        if t.dtype not in _NEW_DTYPES:
            raise TypeError(f"new k/v must be bf16 or fp32, got {t.dtype}")
    if (k_new.stride(-1) != 1 or v_new.stride(-1) != 1
            or v_new.get_device() != k_new.get_device()):
        raise ValueError("new k/v need a contiguous last dim on one device")


def _check(k_cache, v_cache, k_new, v_new, index, stride=None) -> int:
    """Raise unless the new k/v and the caches are what the write kernels
    take: positions ``stride`` bytes apart (default: contiguous caches).
    The caches are compared by their kept records (``quant.pair_stride``);
    caches that do not fit them are checked in full (``check_caches``).
    Returns the position stride."""
    _check_new(k_new, v_new)
    b, h, d = k_new.shape
    ps = (pair_stride(k_cache, v_cache, b, h, d, k_new.get_device(), index)
          or check_caches(k_cache, v_cache, b, h, d, k_new.device, index))
    if ps != (stride or k_cache.q.shape[3]):
        raise ValueError(f"the write kernels need cache positions "
                         f"{stride or k_cache.q.shape[3]} bytes apart")
    return ps


def _launch(k_cache, v_cache, k_new, v_new, index, packed: int) -> None:
    """B3 (packed 0) or B10 (packed 1) over checked caches (``_check``)."""
    if k_new.dtype != v_new.dtype:      # one type for the kernel: fp32 is
        k_new, v_new = k_new.float(), v_new.float()   # exact for bf16
    b, h, d = k_new.shape
    k_sb, k_sh = k_new.stride()[:2]
    v_sb, v_sh = v_new.stride()[:2]
    lk, lv = k_cache.layout(), v_cache.layout()
    status = _build.library().mas_kv_write(
        k_new.data_ptr(), v_new.data_ptr(), lk[7], lk[8], lv[7], lv[8],
        index.data_ptr(), b, h, k_sb, k_sh, v_sb, v_sh, lk[2], d,
        decode_width(d), lk[4], packed, int(k_new.dtype == torch.bfloat16),
        _build.stream(lk[6]))
    _build.check(status, "kv_write")


# --- B3: the lane caches ----------------------------------------------------

def _quantized(new: torch.Tensor, width: int, bits: int):
    """new [B, H, d] -> (values [B, H, width bytes], scales [B, H]) of one
    padded position."""
    values = width * 2 if bits == 4 else width
    q, scale = quantize_values(pad_values(new, values), bits)
    return (pack_int4(q) if bits == 4 else q), scale


def write_quant_kv_plain(k_cache: QuantCache, v_cache: QuantCache,
                         k_new: torch.Tensor, v_new: torch.Tensor,
                         index: torch.Tensor) -> None:
    """Plain twin: quantize k_new/v_new [B, H, d] and write them in place at
    position ``index`` (1-element int32 tensor) of the caches, the columns
    past d as zeros."""
    pos = index.to(device=k_cache.q.device, dtype=torch.long)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        q, scale = _quantized(new, cache.q.shape[-1], cache.bits)
        cache.q.index_copy_(2, pos, q[:, :, None])
        cache.scale.index_copy_(2, pos, scale[:, :, None])


def write_quant_kv(k_cache: QuantCache, v_cache: QuantCache,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   index: torch.Tensor) -> None:
    """Quantize one token's k and v ([B, H, d], any batch/head strides)
    and write values and scales in place at ``index`` — a 1-element int32
    tensor on the same device, so no host value of the position is read.
    Kernel B3 for CUDA tensors, plain twin for CPU tensors."""
    if not k_new.is_cuda:
        if k_new.device.type != "cpu":
            raise ValueError(f"write_quant_kv runs on cpu or cuda, got "
                             f"{k_new.device}")
        write_quant_kv_plain(k_cache, v_cache, k_new, v_new, index)
        return
    _check(k_cache, v_cache, k_new, v_new, index)
    _launch(k_cache, v_cache, k_new, v_new, index, 0)
    write_quant_kv.launches += 1


write_quant_kv.launches = 0


# --- B10: the packed cache --------------------------------------------------

@dataclass
class PackedQuantCache:
    """One layer's quantized k and v decode cache in one buffer,
    preallocated at full length and written in place."""

    kv: torch.Tensor      # int8 [B, H, T, 2D] or uint8 [B, H, T, D] (int4)
    scale: torch.Tensor   # fp32 [2, B, H, T]: [0] k scales, [1] v scales
    bits: int
    # (kv, scale, views) of the first ``views`` call
    _kept: tuple = field(default=None, init=False, repr=False,
                         compare=False)

    @classmethod
    def empty(cls, batch: int, heads: int, length: int, head_dim: int,
              bits: int, device=None) -> "PackedQuantCache":
        """Zero values and unit scales, as ``seed_packed_cache`` of the JAX
        package leaves the unwritten positions; k and v each
        ``cache_width(head_dim, bits)`` bytes a position."""
        qmax_for(bits)
        width = 2 * cache_width(head_dim, bits)
        dtype = torch.uint8 if bits == 4 else torch.int8
        return cls(torch.zeros((batch, heads, length, width), dtype=dtype,
                               device=device),
                   torch.ones((2, batch, heads, length), dtype=torch.float32,
                              device=device), bits)

    def views(self):
        """(k, v) ``QuantCache`` views of the two halves, positions
        ``kv.shape[-1]`` bytes apart; nothing is copied.  Made once and
        kept (with their layout records) while ``kv`` and ``scale`` stay."""
        kept = self._kept
        if kept is None or kept[0] is not self.kv or kept[1] is not self.scale:
            w = self.kv.shape[-1] // 2
            kept = (self.kv, self.scale,
                    (QuantCache(self.kv[..., :w], self.scale[0], self.bits),
                     QuantCache(self.kv[..., w:], self.scale[1], self.bits)))
            self._kept = kept
        return kept[2]


def seed_packed_cache(k: torch.Tensor, v: torch.Tensor, total: int,
                      bits: int) -> PackedQuantCache:
    """Prefill k/v [B, H, prefix, d] float -> a ``total``-length packed
    cache with the prefix quantized in place, zero values and unit scales
    beyond it (``mas_tpu/ops/decode_cache.py::seed_packed_cache``)."""
    b, h, prefix, d = k.shape
    cache = PackedQuantCache.empty(b, h, total, d, bits, k.device)
    width = decode_width(d)
    vals, scales = [], []
    for t in (k, v):
        q, s = quantize_values(pad_values(t, width), bits)
        vals.append(pack_int4(q) if bits == 4 else q)
        scales.append(s)
    cache.kv[:, :, :prefix] = torch.cat(vals, dim=-1)
    cache.scale[:, :, :, :prefix] = torch.stack(scales)
    return cache


def write_packed_kv_plain(cache: PackedQuantCache, k_new: torch.Tensor,
                          v_new: torch.Tensor, index: torch.Tensor) -> None:
    """Plain twin of B10: quantize k_new/v_new [B, H, d] and write values
    and scales in place at position ``index`` of the packed cache, the
    columns past d as zeros."""
    pos = index.to(device=cache.kv.device, dtype=torch.long)
    width = cache.kv.shape[-1] // 2
    vals, scales = zip(*(_quantized(new, width, cache.bits)
                         for new in (k_new, v_new)))
    cache.kv.index_copy_(2, pos, torch.cat(vals, dim=-1)[:, :, None])
    cache.scale.index_copy_(3, pos, torch.stack(scales)[..., None])


def write_packed_kv(cache: PackedQuantCache, k_new: torch.Tensor,
                    v_new: torch.Tensor, index: torch.Tensor) -> None:
    """Quantize one token's k and v ([B, H, d], any batch/head strides)
    and write values and both scales in place at ``index`` (1-element int32
    device tensor) of the packed cache.  Kernel B10 for CUDA tensors, plain
    twin for CPU tensors."""
    if not k_new.is_cuda:
        if k_new.device.type != "cpu":
            raise ValueError(f"write_packed_kv runs on cpu or cuda, got "
                             f"{k_new.device}")
        write_packed_kv_plain(cache, k_new, v_new, index)
        return
    views = cache.views()
    _check(*views, k_new, v_new, index, cache.kv.shape[3])
    _launch(*views, k_new, v_new, index, 1)
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
