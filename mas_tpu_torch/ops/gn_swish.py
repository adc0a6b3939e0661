"""Fused GroupNorm(32) + swish forward over NHWC (kernel B4).

Replaces ``mas_tpu/ops/pallas/gn_swish.py::_kernel`` (launched by
``_gn_swish_fwd_stats_pallas`` / ``_gn_swish_fwd_pallas``), the prologue of
every ResnetBlock conv and the decoder's ``norm_out``.  Returns
swish(GroupNorm(x) * scale + bias) in x's dtype and the fp32 per-(b, g)
stats [B, 2, G] = (mean, rstd) that a backward kernel (B8) will reuse.

What bounds it on the H100: bytes.  Every element is read twice (stats,
then apply) and written once, with ~10 flops in between; at the decoder's
largest shape ([4, 256, 256, 128] bf16) that is about 100 MB of traffic.

What the design does about it: three Triton launches.
  1. partial: one program per (b, chunk of rows) holds a [rows, C] tile in
     registers and writes each channel's chunk mean and sum of squared
     deviations from it (two passes over registers, not over memory);
  2. reduce: one program per (b, g) merges the chunk statistics with the
     parallel-variance formula (Chan et al.), never E[x^2] - mean^2, which
     cancels badly for bf16 inputs with a large mean (the Pallas kernel
     uses that form);
  3. apply: one program per (b, chunk) re-reads the tile, normalizes with
     the group stats, applies the affine and swish, and stores.
The partial statistics are 2 * C fp32 values per chunk of 8192 elements
(under 0.1% of the traffic).
"""

from __future__ import annotations

import torch

from .norms import _normalize, group_norm_stats, swish

tl = None  # triton.language, bound on first launch
_TILE = 8192          # elements of x per program in passes 1 and 3
_REDUCE_CHUNKS = 64   # chunk statistics merged per loop step in pass 2
_JIT = {}


def _gn_partial_kernel(x_ptr, part_ptr, n_rows, n_chunks,
                       C: tl.constexpr, ROWS: tl.constexpr):
    b = tl.program_id(0)
    ch = tl.program_id(1)
    r = ch * ROWS + tl.arange(0, ROWS)
    cols = tl.arange(0, C)
    rmask = r < n_rows
    offs = (b.to(tl.int64) * n_rows + r.to(tl.int64))[:, None] * C
    x = tl.load(x_ptr + offs + cols[None, :], mask=rmask[:, None],
                other=0.0).to(tl.float32)
    cnt = tl.minimum(n_rows - ch * ROWS, ROWS).to(tl.float32)
    mean = tl.sum(x, axis=0) / cnt
    dev = tl.where(rmask[:, None], x - mean[None, :], 0.0)
    m2 = tl.sum(dev * dev, axis=0)
    out = part_ptr + (b.to(tl.int64) * n_chunks + ch) * 2 * C
    tl.store(out + cols, mean)
    tl.store(out + C + cols, m2)


def _gn_reduce_kernel(part_ptr, stats_ptr, n_rows, n_chunks, eps,
                      G: tl.constexpr, C: tl.constexpr, CPG: tl.constexpr,
                      ROWS: tl.constexpr, NB: tl.constexpr):
    b = tl.program_id(0)
    g = tl.program_id(1)
    cols = g * CPG + tl.arange(0, CPG)
    total = n_rows * CPG * 1.0
    base = part_ptr + b.to(tl.int64) * n_chunks * 2 * C
    acc = tl.zeros([NB, CPG], tl.float32)
    for start in range(0, n_chunks, NB):
        ci = start + tl.arange(0, NB)
        cm = ci < n_chunks
        cnt = tl.minimum(n_rows - ci * ROWS, ROWS).to(tl.float32)
        mean_i = tl.load(base + (ci * 2 * C)[:, None] + cols[None, :],
                         mask=cm[:, None], other=0.0)
        acc += tl.where(cm[:, None], cnt[:, None] * mean_i, 0.0)
    mean = tl.sum(tl.sum(acc, axis=1), axis=0) / total
    acc2 = tl.zeros([NB, CPG], tl.float32)
    for start in range(0, n_chunks, NB):
        ci = start + tl.arange(0, NB)
        cm = ci < n_chunks
        cnt = tl.minimum(n_rows - ci * ROWS, ROWS).to(tl.float32)
        ptr = base + (ci * 2 * C)[:, None] + cols[None, :]
        mean_i = tl.load(ptr, mask=cm[:, None], other=0.0)
        m2_i = tl.load(ptr + C, mask=cm[:, None], other=0.0)
        dm = mean_i - mean
        acc2 += tl.where(cm[:, None], m2_i + cnt[:, None] * dm * dm, 0.0)
    var = tl.sum(tl.sum(acc2, axis=1), axis=0) / total
    rstd = tl.rsqrt(var + eps)
    tl.store(stats_ptr + b * 2 * G + g, mean)
    tl.store(stats_ptr + b * 2 * G + G + g, rstd)


def _gn_apply_kernel(x_ptr, y_ptr, stats_ptr, scale_ptr, bias_ptr, n_rows,
                     G: tl.constexpr, C: tl.constexpr, CPG: tl.constexpr,
                     ROWS: tl.constexpr):
    b = tl.program_id(0)
    ch = tl.program_id(1)
    r = ch * ROWS + tl.arange(0, ROWS)
    cols = tl.arange(0, C)
    rmask = r < n_rows
    offs = ((b.to(tl.int64) * n_rows + r.to(tl.int64))[:, None] * C
            + cols[None, :])
    x = tl.load(x_ptr + offs, mask=rmask[:, None], other=0.0).to(tl.float32)
    grp = cols // CPG
    mean = tl.load(stats_ptr + b * 2 * G + grp)
    rstd = tl.load(stats_ptr + b * 2 * G + G + grp)
    w = tl.load(scale_ptr + cols).to(tl.float32)
    bias = tl.load(bias_ptr + cols).to(tl.float32)
    a = (x - mean[None, :]) * rstd[None, :] * w[None, :] + bias[None, :]
    y = a * tl.sigmoid(a)
    tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=rmask[:, None])


def _kernels():
    """Import triton and JIT-wrap the kernels on first launch (the CPU tests
    import this module where triton does not exist)."""
    global tl
    if not _JIT:
        import triton
        import triton.language as language

        tl = language
        _JIT["partial"] = triton.jit(_gn_partial_kernel)
        _JIT["reduce"] = triton.jit(_gn_reduce_kernel)
        _JIT["apply"] = triton.jit(_gn_apply_kernel)
    return _JIT


def gn_swish_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   num_groups: int = 32, eps: float = 1e-6):
    """Plain twin: (swish(group_norm(x)) in x's dtype, stats [B, 2, G])."""
    mean, rstd = group_norm_stats(x, num_groups, eps)
    a = _normalize(x, mean, rstd, scale, bias)
    return swish(a).to(x.dtype), torch.stack([mean, rstd], dim=1)


def _check(x, scale, bias, num_groups):
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    c = x.shape[-1]
    if c & (c - 1) or c % num_groups:
        raise ValueError(f"channels must be a power of two divisible by "
                         f"{num_groups}, got {c}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bf16 or fp32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor")
    for name, p in (("scale", scale), ("bias", bias)):
        if tuple(p.shape) != (c,) or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [{c}] tensor")
        if p.device != x.device:
            raise ValueError(f"{name} is on {p.device}, x on {x.device}")


def gn_swish(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             num_groups: int = 32, eps: float = 1e-6):
    """NHWC x (contiguous, C a power of two) -> (swish(GroupNorm(x)), stats
    [B, 2, G] fp32 rows (mean, rstd)).  Kernel for CUDA tensors, plain twin
    for CPU tensors."""
    if x.device.type == "cpu":
        return gn_swish_plain(x, scale, bias, num_groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"gn_swish runs on cpu or cuda, got {x.device}")
    _check(x, scale, bias, num_groups)
    jit = _kernels()
    b, h, w, c = x.shape
    n_rows = h * w
    rows = max(1, min(_TILE // c, 1 << (n_rows - 1).bit_length()))
    n_chunks = (n_rows + rows - 1) // rows
    part = torch.empty((b, n_chunks, 2, c), dtype=torch.float32,
                       device=x.device)
    stats = torch.empty((b, 2, num_groups), dtype=torch.float32,
                        device=x.device)
    out = torch.empty_like(x)
    cpg = c // num_groups
    # Triton launches on the current stream and raises if a launch fails
    with torch.cuda.device(x.device):
        jit["partial"][(b, n_chunks)](x, part, n_rows, n_chunks, C=c,
                                      ROWS=rows, num_warps=8)
        jit["reduce"][(b, num_groups)](part, stats, n_rows, n_chunks,
                                       float(eps), G=num_groups, C=c,
                                       CPG=cpg, ROWS=rows,
                                       NB=_REDUCE_CHUNKS, num_warps=4)
        jit["apply"][(b, n_chunks)](x, out, stats, scale, bias, n_rows,
                                    G=num_groups, C=c, CPG=cpg, ROWS=rows,
                                    num_warps=8)
    gn_swish.launches += 1
    return out, stats


gn_swish.launches = 0
