"""int8/int4 KV-cache quantization and the quantized decode read (kernel B2).

Counterpart of ``mas_tpu/ops/quant.py``.  Same scheme: symmetric
per-(batch, head, position) quantization over the d feature dim,

    k_q[t] = clip(round(k[t] / ks[t]), -qmax, qmax),  ks[t] = max|k[t]| / qmax
    s[t]   = (q . k_q[t]) * ks[t]          (scale folds in after the dot)
    out    = sum_t (p[t] * vs[t]) * v_q[t] (v scale folds into the probs)

with qmax 127 (int8) or 7 (int4).  The port's cache layout is its own:
values [B, H, T, D] int8, or [B, H, T, D/2] uint8 for int4 (torch has no
int4: two nibbles per byte, low nibble = even dim); scales [B, H, T] fp32.
D is the width that holds the head dim d (``decode_width``: the least of
``DECODE_HEAD_DIMS`` >= d, or the least multiple of 256 >= d above 256): a
position is allocated at D values and the columns past d stay zero, as
B1/B6 pad q, k and v (``ops/attention.py::pad_head_dim``).  An odd d's last
int4 byte pairs column d - 1 with a zero nibble.  Zero k columns add
nothing to q . k, zero v columns give output columns that are never
written, and zeros do not change a position's amax, so the padded cache
holds the JAX package's values in its first d columns.  Each position's
values are contiguous, which is what the kernel reads.

The values may also be a view whose positions lie further apart than one
position's bytes: ``stride(2)`` bytes apart, with ``stride(1) = T *
stride(2)`` and ``stride(0) = H * stride(1)``.  That is how the k and v
halves of the packed cache (``ops/decode_cache.py::PackedQuantCache``) are
read in place; the kernel takes the stride as its ``pos_stride`` argument.

``decode_attention_quant`` launches ``csrc/decode_quant.cu`` for CUDA
tensors and takes ``decode_attention_quant_plain`` only for CPU tensors.
The kernel splits each (b, h) row's positions over ``decode_split(B * H)``
blocks of one thread-block cluster and merges their softmax states in
shared memory (see the source); it is instantiated for D = 32, 64, 128
and 256 (``DECODE_HEAD_DIMS``), takes a wider position in chunks of 256
columns through the D = 256 instance, reads q's first d columns and
writes an output of d columns.

A cache's layout is checked at its first use by a kernel and kept on the
cache (``QuantCache.layout``); each call then compares that record with
its q or new k/v and checks the index tensor.  A cache whose record does
not fit goes through ``check_caches``, which raises what is wrong.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field

import torch
from torch.nn import functional as F

from .. import _build

_NEG_INF = -1e30
_EPS = 1e-8
DECODE_HEAD_DIMS = (32, 64, 128, 256)   # the decode kernels' instances D
# blocks the decode kernels aim for: four on each of the H100's 132 SMs
_TARGET_BLOCKS = 4 * 132
MAX_SPLIT = 8                      # portable thread-block cluster size


@functools.lru_cache(maxsize=None)
def decode_split(rows: int) -> int:
    """Blocks per (b, h) row of the decode kernels B2 and B9, from the
    number of rows B * H alone: the least power of two that gives
    ``_TARGET_BLOCKS`` blocks, at most ``MAX_SPLIT`` (one cluster).  It
    never depends on the decode position or the cache layout, so the launch
    shape is fixed for a sampling run and the packed and lane reads of the
    same values split alike."""
    if rows < 1:
        raise ValueError(f"rows must be >= 1, got {rows}")
    split = 1
    while split < MAX_SPLIT and split * rows < _TARGET_BLOCKS:
        split *= 2
    return split


@functools.lru_cache(maxsize=None)
def decode_width(head_dim: int) -> int:
    """D, the values a decode cache position holds for head dim d: the
    least of ``DECODE_HEAD_DIMS`` >= d, or above 256 the least multiple of
    256 >= d (the decode kernels take it in chunks of 256).  D is even, so
    an int4 cache of an odd d pairs its last column with a zero nibble."""
    if head_dim < 1:
        raise ValueError(f"head_dim must be >= 1, got {head_dim}")
    top = DECODE_HEAD_DIMS[-1]
    if head_dim > top:
        return -(-head_dim // top) * top
    return next(w for w in DECODE_HEAD_DIMS if head_dim <= w)


@functools.lru_cache(maxsize=None)
def cache_width(head_dim: int, bits: int) -> int:
    """Bytes of one position of a k or v value cache for head dim d: D
    int8 values or D/2 bytes of int4 nibbles (``decode_width``)."""
    width = decode_width(head_dim)
    return width // 2 if bits == 4 else width


def qmax_for(bits: int) -> float:
    if bits not in (4, 8):
        raise ValueError(f"cache bits must be 4 or 8, got {bits}")
    return 7.0 if bits == 4 else 127.0


@dataclass
class QuantCache:
    """One tensor's quantized decode cache, preallocated at full length and
    written in place."""

    q: torch.Tensor       # int8 [B, H, T, D] or uint8 [B, H, T, D/2]
    scale: torch.Tensor   # fp32 [B, H, T]
    bits: int
    # (q, scale, record) of the first kernel use: see ``layout``
    _kept: tuple = field(default=None, init=False, repr=False,
                         compare=False)

    @classmethod
    def empty(cls, batch: int, heads: int, length: int, head_dim: int,
              bits: int, device=None) -> "QuantCache":
        """Zero values and unit scales, as the JAX sampler allocates; each
        position ``cache_width(head_dim, bits)`` bytes wide."""
        qmax_for(bits)
        shape = (batch, heads, length, cache_width(head_dim, bits))
        dtype = torch.uint8 if bits == 4 else torch.int8
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.ones((batch, heads, length), dtype=torch.float32,
                              device=device), bits)

    def values(self) -> torch.Tensor:
        """Integer values as int8 [B, H, T, D] (int4 unpacked)."""
        return unpack_int4(self.q) if self.bits == 4 else self.q

    def layout(self):
        """What the kernels need of this cache, checked at its first use and
        kept: (B, H, T, bytes of a position, bits, position stride, device
        index (``get_device``), values address, scales address), or None
        when no kernel reads the cache (``check_caches`` then says why).
        Replacing ``q`` or ``scale`` makes a new record."""
        kept = self._kept
        if kept is None or kept[0] is not self.q or kept[1] is not self.scale:
            kept = (self.q, self.scale, _layout_of(self))
            self._kept = kept
        return kept[2]


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


def pad_values(f: torch.Tensor, width: int) -> torch.Tensor:
    """f [..., d] with zero columns up to ``width`` values (f itself when d
    is ``width``): what a padded cache position holds before quantizing."""
    d = f.shape[-1]
    if d > width:
        raise ValueError(f"{d} values do not fit a {width}-value position")
    return f if d == width else F.pad(f, (0, width - d))


def quantize_kv(kv: torch.Tensor, bits: int = 8) -> QuantCache:
    """[B, H, T, d] float -> QuantCache (values packed for int4), each
    position padded with zeros to ``decode_width(d)`` values."""
    kv = pad_values(kv, decode_width(kv.shape[-1]))
    q, scale = quantize_values(kv, bits)
    return QuantCache(pack_int4(q) if bits == 4 else q, scale, bits)


def dequantize_kv(cache: QuantCache) -> torch.Tensor:
    return cache.values().float() * cache.scale[..., None]


def decode_attention_quant_plain(q, k_cache: QuantCache,
                                 v_cache: QuantCache, index: torch.Tensor):
    """q [B, H, 1, d]; positions <= index (1-element int32 tensor) are
    visible; the caches' first d columns are read.  Returns [B, H, 1, d] in
    q's dtype; fp32 throughout."""
    d = q.shape[-1]
    s = torch.matmul(q.float() * (1.0 / math.sqrt(d)),
                     k_cache.values()[..., :d].float().transpose(-1, -2))
    s = s * k_cache.scale[:, :, None, :]
    kpos = torch.arange(s.shape[-1], device=q.device)
    s = s.masked_fill(kpos > index.to(q.device), _NEG_INF)
    p = torch.softmax(s, dim=-1)
    pv = p * v_cache.scale[:, :, None, :]
    return torch.matmul(pv, v_cache.values()[..., :d].float()).to(q.dtype)


def position_stride(values: torch.Tensor) -> int:
    """Bytes between the positions of a [B, H, T, w] int8/uint8 value
    cache laid out as the kernels read it: a contiguous last dim, positions
    ``stride(2) >= w`` apart, and (b, h) rows T positions apart, with the
    base and the stride 16-byte aligned; raise otherwise."""
    _, h, t, w = values.shape
    ps = values.stride(2)
    if (values.stride(3) != 1 or ps < w or values.stride(1) != t * ps
            or values.stride(0) != h * t * ps):
        raise ValueError(f"cache values need strides (H*T*p, T*p, p, 1) with "
                         f"p >= {w}, got {values.stride()}")
    if ps % 16 or values.data_ptr() % 16:
        raise ValueError("cache values need a 16-byte aligned base and "
                         "position stride")
    return ps


def _layout_of(c: QuantCache):
    """``QuantCache.layout``'s record, or None for a cache that
    ``check_caches`` refuses whatever it is called with."""
    q, s = c.q, c.scale
    if (c.bits not in (4, 8) or q.dim() != 4
            or q.dtype != (torch.uint8 if c.bits == 4 else torch.int8)
            or s.dtype != torch.float32 or s.shape != q.shape[:3]
            or not s.is_contiguous() or s.get_device() != q.get_device()):
        return None
    try:
        ps = position_stride(q)
    except ValueError:
        return None
    b, h, t, w = q.shape
    return (b, h, t, w, c.bits, ps, q.get_device(), q.data_ptr(),
            s.data_ptr())


def pair_stride(k_cache: QuantCache, v_cache: QuantCache, batch: int,
                heads: int, head_dim: int, device_index: int,
                index: torch.Tensor) -> int:
    """The lean check of a kernel call: the position stride of two caches
    whose kept records (``QuantCache.layout``) agree and fit [batch, heads,
    T, cache_width(head_dim)] on CUDA device ``device_index``, with
    ``index`` a 1-element int32 tensor there; else 0, and ``check_caches``
    then raises what is wrong."""
    lk, lv = k_cache.layout(), v_cache.layout()
    if lk is None or lv is None or lk[:7] != lv[:7]:
        return 0
    b, h, _, w, bits, ps, dev = lk[:7]
    if (b != batch or h != heads or dev != device_index
            or w != cache_width(head_dim, bits)
            or index.dtype != torch.int32 or index.numel() != 1
            or index.get_device() != device_index):
        return 0
    return ps


def check_caches(k_cache: QuantCache, v_cache: QuantCache, batch: int,
                 heads: int, head_dim: int, device,
                 index: torch.Tensor) -> int:
    """Raise unless both caches are [batch, heads, T, W] int8 (int4: uint8)
    with W = ``cache_width(head_dim, bits)`` bytes a position, one position
    stride (``position_stride``) and contiguous fp32 [batch, heads, T]
    scales on ``device``, of one bit width, and ``index`` is a 1-element
    int32 tensor there.  Returns the position stride in bytes."""
    if k_cache.bits != v_cache.bits:
        raise ValueError("k and v caches must share one bit width")
    width = cache_width(head_dim, k_cache.bits)
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
        if not c.scale.is_contiguous():
            raise ValueError("cache scales must be contiguous")
        if c.q.device != device or c.scale.device != device:
            raise ValueError(f"caches must be on {device}")
    ps = position_stride(k_cache.q)
    if position_stride(v_cache.q) != ps:
        raise ValueError("k and v caches must share one position stride")
    check_index(index, device)
    return ps


def check_index(index: torch.Tensor, device) -> None:
    """The decode position: a 1-element int32 tensor on ``device``, so no
    kernel launch needs its host value."""
    if (index.dtype != torch.int32 or index.numel() != 1
            or index.device != device):
        raise ValueError(f"index must be a 1-element int32 tensor on "
                         f"{device}")


def check_query(q) -> None:
    """Raise unless q is a bf16 or fp32 [B, H, 1, d] decode query with
    d >= 1 and a contiguous last dim (the decode kernels B2 and B9 read it
    so)."""
    _, _, one, d = q.shape
    if one != 1 or d < 1:
        raise ValueError(f"q must be [B, H, 1, d] with head_dim d >= 1, got "
                         f"{tuple(q.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bf16 or fp32, got {q.dtype}")
    if q.stride(-1) != 1:
        raise ValueError("q needs a contiguous last dim")


def _check(q, k_cache, v_cache, index) -> int:
    """Raise unless the kernel takes q, the caches and index; returns the
    position stride.  The caches are compared by their kept records
    (``pair_stride``); caches that do not fit them are checked in full."""
    check_query(q)
    b, h, _, d = q.shape
    return (pair_stride(k_cache, v_cache, b, h, d, q.get_device(), index)
            or check_caches(k_cache, v_cache, b, h, d, q.device, index))


def decode_attention_quant(q, k_cache: QuantCache, v_cache: QuantCache,
                           index: torch.Tensor):
    """Single-token attention over quantized caches, masked to <= index.

    q [B, H, 1, d] (any batch/head strides, contiguous last dim), caches as
    ``QuantCache`` [B, H, T, cache_width(d)] whose values
    may be position-strided views (see the module docstring), ``index`` a
    1-element int32 tensor on q's device.  Returns a contiguous
    [B, H, 1, d] tensor in q's dtype.
    """
    if not q.is_cuda:
        if q.device.type == "cpu":
            return decode_attention_quant_plain(q, k_cache, v_cache, index)
        raise ValueError(f"decode_attention_quant runs on cpu or cuda, got "
                         f"{q.device}")
    pos_stride = _check(q, k_cache, v_cache, index)
    b, h, _, d = q.shape
    out = torch.empty((b, h, 1, d), dtype=q.dtype, device=q.device)
    lk, lv = k_cache.layout(), v_cache.layout()
    q_sb, q_sh = q.stride()[:2]
    status = _build.library().mas_decode_quant(
        q.data_ptr(), lk[7], lk[8], lv[7], lv[8], index.data_ptr(),
        out.data_ptr(), b, h, lk[2], pos_stride, q_sb, q_sh, decode_width(d),
        d, lk[4], int(q.dtype == torch.bfloat16), decode_split(b * h),
        1.0 / math.sqrt(d), _build.stream(lk[6]))
    _build.check(status, "decode_quant")
    decode_attention_quant.launches += 1
    return out


decode_attention_quant.launches = 0
