"""Fused quantize-and-write of one token into the decode caches (kernel B3).

Replaces ``mas_tpu/ops/decode_cache.py::_lane_write_kernel`` (public
``update_quant_caches_aliased``): one launch quantizes the new token's k
and v (per-position amax over d, scale, round half to even, clip —
``mas_tpu/ops/quant.py:60-66``) and stores values and scales at ``index``.

What bounds it on the H100: nothing but launch latency.  It moves
B * H * (2 * d + 8) bytes per call (about 260 KB at the serving batch) and
does one small reduction over d = 64 per row.

What the design does about it: one Triton program per block of 16 (b, h)
rows handles both k and v, so the write is one launch per layer and step.
The division is ``tl.div_rn`` (IEEE round-to-nearest, as torch and XLA
divide) and the rounding ``rint``, so the stored integers equal the plain
twin's bit for bit.

The caches are written IN PLACE: they are preallocated at full length by
the sampler and never copied.  The JAX function returns new arrays.
"""

from __future__ import annotations

import torch

from .quant import (HEAD_DIM, QuantCache, check_caches, pack_int4,
                    quantize_values)

tl = None         # triton.language, bound on first launch
libdevice = None  # triton's libdevice, bound on first launch
_ROWS = 16        # (b, h) rows per program
_JIT = {}


def _quantize_store(src_ptr, s_sb, s_sh, q_ptr, sc_ptr, rows, rmask, heads,
                    t_len, idx, BITS: tl.constexpr, D: tl.constexpr):
    """Quantize rows [R, D] of src (row r = b * heads + h) and store them at
    position idx of the [rows, T, D or D/2] cache and [rows, T] scales."""
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
        tl.store(q_ptr + dst[:, None] * D + cols[None, :], qv.to(tl.int8),
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
        tl.store(q_ptr + dst[:, None] * (D // 2) + half[None, :],
                 byte.to(tl.uint8), mask=rmask[:, None])
    tl.store(sc_ptr + dst, scale, mask=rmask)


def _write_kernel(k_ptr, k_sb, k_sh, v_ptr, v_sb, v_sh, kq_ptr, ks_ptr,
                  vq_ptr, vs_ptr, idx_ptr, n_rows, heads, t_len,
                  BITS: tl.constexpr, D: tl.constexpr, R: tl.constexpr):
    rows = tl.program_id(0) * R + tl.arange(0, R)
    rmask = rows < n_rows
    idx = tl.load(idx_ptr).to(tl.int64)
    _quantize_store(k_ptr, k_sb, k_sh, kq_ptr, ks_ptr, rows, rmask, heads,
                    t_len, idx, BITS, D)
    _quantize_store(v_ptr, v_sb, v_sh, vq_ptr, vs_ptr, rows, rmask, heads,
                    t_len, idx, BITS, D)


def _kernels():
    """Import triton and JIT-wrap the kernel on first launch (the CPU tests
    import this module where triton does not exist)."""
    global tl, libdevice
    if not _JIT:
        import triton
        import triton.language as language
        from triton.language.extra import libdevice as ld

        tl, libdevice = language, ld
        # the write kernel calls _quantize_store by its global name, so the
        # global must be the JIT function by the time the kernel compiles
        globals()["_quantize_store"] = triton.jit(_quantize_store)
        _JIT["write"] = triton.jit(_write_kernel)
    return _JIT


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


def _check(k_cache, v_cache, k_new, v_new, index):
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
    check_caches(k_cache, v_cache, b, h, k_new.device, index)


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
    jit = _kernels()
    b, h, d = k_new.shape
    n_rows = b * h
    grid = ((n_rows + _ROWS - 1) // _ROWS,)
    # Triton launches on the current stream and raises if a launch fails
    with torch.cuda.device(k_new.device):
        jit["write"][grid](
            k_new, k_new.stride(0), k_new.stride(1),
            v_new, v_new.stride(0), v_new.stride(1),
            k_cache.q, k_cache.scale, v_cache.q, v_cache.scale, index,
            n_rows, h, k_cache.q.shape[2],
            BITS=k_cache.bits, D=d, R=_ROWS, num_warps=4)
    write_quant_kv.launches += 1


write_quant_kv.launches = 0
