"""Fused GroupNorm(32) + swish over NHWC: forward (kernel B4), backward
(kernel B8), and ``GNSwishFunction``, which joins them for autograd.

B4 replaces ``mas_tpu/ops/pallas/gn_swish.py::_kernel`` (launched by
``_gn_swish_fwd_stats_pallas`` / ``_gn_swish_fwd_pallas``), the prologue of
every ResnetBlock conv and of ``norm_out``.  It returns swish(GroupNorm(x) *
scale + bias) in x's dtype and the fp32 per-(b, g) stats [B, 2, G] =
(mean, rstd) that B8 reuses.

B8 replaces ``_bwd_reduce_kernel`` and ``_bwd_apply_kernel`` (launched by
``_gn_swish_bwd_pallas``): from the saved stats it recomputes x^ = (x -
mean) * rstd and dx^ = g * swish'(a) * scale per element, and returns

  dx = rstd * (dx^ - (S1 + x^ * S2) / N),  S1 = sum dx^,  S2 = sum dx^ x^

(sums per (b, g), N = H * W * C / G), dscale = sum g swish'(a) x^ and
dbias = sum g swish'(a) over all rows.  The JAX package's TPU default is
its jnp-recompute VJP, B8 being opt-in there because it lost to XLA's
fused VJP on the TPU; the port uses B8 on the card.

What bounds both on the H100: bytes.  B4 reads every element twice and
writes it once with ~10 flops in between (~100 MB at the decoder's largest
[4, 256, 256, 128] bf16).  B8 reads x and g twice each and writes dx once
(~335 MB at the seg encoder's [2, 256, 256, 128] fp32).

What the design does about it: three Triton launches each, with one tiling.
B4:
  1. partial: one program per (b, chunk of rows) holds a [rows, C] tile in
     registers and writes each channel's chunk mean and sum of squared
     deviations from it (two passes over registers, not over memory);
  2. reduce: one program per (b, g) merges the chunk statistics with the
     parallel-variance formula (Chan et al.), never E[x^2] - mean^2, which
     cancels badly for bf16 inputs with a large mean (the Pallas kernel
     uses that form);
  3. apply: one program per (b, chunk) re-reads the tile, normalizes with
     the group stats, applies the affine and swish, and stores.
B8:
  1. reduce: one program per (b, chunk) recomputes x^ and dx^ from x, g and
     the stats, and writes per-channel partial sums of dx^, dx^ x^, g
     swish'(a) and g swish'(a) x^ in fp32;
  2. merge: one program per group sums the chunk partials into S1, S2 per
     (b, g) and dscale, dbias per channel (a loop over b: no atomics, so
     the result does not depend on the launch order);
  3. apply: one program per (b, chunk) recomputes x^ and dx^ and writes dx
     in x's dtype.
The partial sums are 2 * C (B4) or 4 * C (B8) fp32 values per chunk of
8192 or 4096 elements: ~0.1% of the traffic.
"""

from __future__ import annotations

import torch

from .norms import _normalize, group_norm_stats, swish

tl = None  # triton.language, bound on first launch
_TILE = 8192          # elements of x per program in passes 1 and 3 (B4)
_BWD_TILE = 4096      # elements of x (and of g) per program in B8
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


def _recompute(x_ptr, g_ptr, stats_ptr, scale_ptr, bias_ptr, offs, rmask, b,
               G: tl.constexpr, C: tl.constexpr, CPG: tl.constexpr):
    """[rows, C] tile -> (x^, g swish'(a), dx^, rstd per column) in fp32."""
    cols = tl.arange(0, C)
    x = tl.load(x_ptr + offs, mask=rmask[:, None], other=0.0).to(tl.float32)
    g = tl.load(g_ptr + offs, mask=rmask[:, None], other=0.0).to(tl.float32)
    grp = cols // CPG
    mean = tl.load(stats_ptr + b * 2 * G + grp)
    rstd = tl.load(stats_ptr + b * 2 * G + G + grp)
    w = tl.load(scale_ptr + cols).to(tl.float32)
    bias = tl.load(bias_ptr + cols).to(tl.float32)
    xhat = (x - mean[None, :]) * rstd[None, :]
    a = xhat * w[None, :] + bias[None, :]
    s = tl.sigmoid(a)
    ga = g * (s * (1.0 + a * (1.0 - s)))     # masked rows: g = 0, so ga = 0
    return xhat, ga, ga * w[None, :], rstd


def _gn_bwd_reduce_kernel(x_ptr, g_ptr, stats_ptr, scale_ptr, bias_ptr,
                          part_ptr, n_rows, n_chunks, G: tl.constexpr,
                          C: tl.constexpr, CPG: tl.constexpr,
                          ROWS: tl.constexpr):
    b = tl.program_id(0)
    ch = tl.program_id(1)
    r = ch * ROWS + tl.arange(0, ROWS)
    cols = tl.arange(0, C)
    rmask = r < n_rows
    offs = ((b.to(tl.int64) * n_rows + r.to(tl.int64))[:, None] * C
            + cols[None, :])
    xhat, ga, dxhat, _ = _recompute(x_ptr, g_ptr, stats_ptr, scale_ptr,
                                    bias_ptr, offs, rmask, b, G, C, CPG)
    out = part_ptr + (b.to(tl.int64) * n_chunks + ch) * 4 * C
    tl.store(out + cols, tl.sum(dxhat, axis=0))
    tl.store(out + C + cols, tl.sum(dxhat * xhat, axis=0))
    tl.store(out + 2 * C + cols, tl.sum(ga, axis=0))
    tl.store(out + 3 * C + cols, tl.sum(ga * xhat, axis=0))


def _gn_bwd_merge_kernel(part_ptr, sums_ptr, dscale_ptr, dbias_ptr, n_batch,
                         n_chunks, G: tl.constexpr, C: tl.constexpr,
                         CPG: tl.constexpr, NB: tl.constexpr):
    g = tl.program_id(0)
    cols = g * CPG + tl.arange(0, CPG)
    dscale = tl.zeros([CPG], tl.float32)
    dbias = tl.zeros([CPG], tl.float32)
    for b in range(0, n_batch):
        base = part_ptr + b.to(tl.int64) * n_chunks * 4 * C
        s1 = tl.zeros([NB, CPG], tl.float32)
        s2 = tl.zeros([NB, CPG], tl.float32)
        sb = tl.zeros([NB, CPG], tl.float32)
        sg = tl.zeros([NB, CPG], tl.float32)
        for start in range(0, n_chunks, NB):
            ci = start + tl.arange(0, NB)
            cm = ci < n_chunks
            ptr = base + (ci.to(tl.int64) * 4 * C)[:, None] + cols[None, :]
            s1 += tl.load(ptr, mask=cm[:, None], other=0.0)
            s2 += tl.load(ptr + C, mask=cm[:, None], other=0.0)
            sb += tl.load(ptr + 2 * C, mask=cm[:, None], other=0.0)
            sg += tl.load(ptr + 3 * C, mask=cm[:, None], other=0.0)
        tl.store(sums_ptr + b * 2 * G + g, tl.sum(tl.sum(s1, axis=1), axis=0))
        tl.store(sums_ptr + b * 2 * G + G + g,
                 tl.sum(tl.sum(s2, axis=1), axis=0))
        dbias += tl.sum(sb, axis=0)
        dscale += tl.sum(sg, axis=0)
    tl.store(dscale_ptr + cols, dscale)
    tl.store(dbias_ptr + cols, dbias)


def _gn_bwd_apply_kernel(x_ptr, g_ptr, dx_ptr, stats_ptr, sums_ptr,
                         scale_ptr, bias_ptr, n_rows, inv_count,
                         G: tl.constexpr, C: tl.constexpr, CPG: tl.constexpr,
                         ROWS: tl.constexpr):
    b = tl.program_id(0)
    ch = tl.program_id(1)
    r = ch * ROWS + tl.arange(0, ROWS)
    cols = tl.arange(0, C)
    rmask = r < n_rows
    offs = ((b.to(tl.int64) * n_rows + r.to(tl.int64))[:, None] * C
            + cols[None, :])
    xhat, _, dxhat, rstd = _recompute(x_ptr, g_ptr, stats_ptr, scale_ptr,
                                      bias_ptr, offs, rmask, b, G, C, CPG)
    grp = cols // CPG
    s1 = tl.load(sums_ptr + b * 2 * G + grp)
    s2 = tl.load(sums_ptr + b * 2 * G + G + grp)
    dx = rstd[None, :] * (dxhat - (s1[None, :] + xhat * s2[None, :])
                          * inv_count)
    tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty),
             mask=rmask[:, None])


def _kernels():
    """Import triton and JIT-wrap the kernels on first launch (the CPU tests
    import this module where triton does not exist)."""
    global tl, _recompute
    if not _JIT:
        import triton
        import triton.language as language

        tl = language
        # the kernels call _recompute by its global name
        _recompute = triton.jit(_recompute)
        _JIT["partial"] = triton.jit(_gn_partial_kernel)
        _JIT["reduce"] = triton.jit(_gn_reduce_kernel)
        _JIT["apply"] = triton.jit(_gn_apply_kernel)
        _JIT["bwd_reduce"] = triton.jit(_gn_bwd_reduce_kernel)
        _JIT["bwd_merge"] = triton.jit(_gn_bwd_merge_kernel)
        _JIT["bwd_apply"] = triton.jit(_gn_bwd_apply_kernel)
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


def gn_swish_bwd_plain(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, stats: torch.Tensor,
                       num_groups: int = 32):
    """Plain twin of B8: the closed-form backward from the saved stats ->
    (dx in x's dtype, dscale, dbias in the parameters' dtypes)."""
    b, h, w, c = x.shape
    cpg = c // num_groups
    shape = (b, h * w, num_groups, cpg)
    mean = stats[:, 0][:, None, :, None]
    rstd = stats[:, 1][:, None, :, None]
    xhat = (x.float().reshape(shape) - mean) * rstd
    sc = scale.float().reshape(num_groups, cpg)
    a = xhat * sc + bias.float().reshape(num_groups, cpg)
    s = torch.sigmoid(a)
    ga = g.float().reshape(shape) * (s * (1.0 + a * (1.0 - s)))
    dxhat = ga * sc
    s1 = dxhat.sum(dim=(1, 3), keepdim=True)
    s2 = (dxhat * xhat).sum(dim=(1, 3), keepdim=True)
    dx = rstd * (dxhat - (s1 + xhat * s2) * (1.0 / (h * w * cpg)))
    return (dx.reshape(x.shape).to(x.dtype),
            (ga * xhat).sum(dim=(0, 1)).reshape(c).to(scale.dtype),
            ga.sum(dim=(0, 1)).reshape(c).to(bias.dtype))


def _check_bwd(x, g, scale, bias, stats, num_groups):
    _check(x, scale, bias, num_groups)
    if g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous {x.dtype} tensor of shape "
                         f"{tuple(x.shape)}, got {g.dtype} {tuple(g.shape)}")
    if (tuple(stats.shape) != (x.shape[0], 2, num_groups)
            or stats.dtype != torch.float32 or not stats.is_contiguous()):
        raise ValueError(f"stats must be contiguous fp32 [{x.shape[0]}, 2, "
                         f"{num_groups}], got {stats.dtype} "
                         f"{tuple(stats.shape)}")
    for name, t in (("g", g), ("stats", stats)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def gn_swish_bwd(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, stats: torch.Tensor,
                 num_groups: int = 32):
    """Backward of ``gn_swish`` from its saved stats: (dx, dscale, dbias).
    Kernel B8 for CUDA tensors, plain twin for CPU tensors."""
    if x.device.type == "cpu":
        return gn_swish_bwd_plain(x, g, scale, bias, stats, num_groups)
    if x.device.type != "cuda":
        raise ValueError(f"gn_swish_bwd runs on cpu or cuda, got {x.device}")
    _check_bwd(x, g, scale, bias, stats, num_groups)
    jit = _kernels()
    b, h, w, c = x.shape
    n_rows = h * w
    rows = max(1, min(_BWD_TILE // c, 1 << (n_rows - 1).bit_length()))
    n_chunks = (n_rows + rows - 1) // rows
    cpg = c // num_groups
    part = torch.empty((b, n_chunks, 4, c), dtype=torch.float32,
                       device=x.device)
    sums = torch.empty((b, 2, num_groups), dtype=torch.float32,
                       device=x.device)
    dscale = torch.empty(c, dtype=torch.float32, device=x.device)
    dbias = torch.empty(c, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        jit["bwd_reduce"][(b, n_chunks)](x, g, stats, scale, bias, part,
                                         n_rows, n_chunks, G=num_groups, C=c,
                                         CPG=cpg, ROWS=rows, num_warps=8)
        jit["bwd_merge"][(num_groups,)](part, sums, dscale, dbias, b,
                                        n_chunks, G=num_groups, C=c,
                                        CPG=cpg, NB=_REDUCE_CHUNKS,
                                        num_warps=4)
        jit["bwd_apply"][(b, n_chunks)](x, g, dx, stats, sums, scale, bias,
                                        n_rows, 1.0 / (n_rows * cpg),
                                        G=num_groups, C=c, CPG=cpg,
                                        ROWS=rows, num_warps=8)
    gn_swish_bwd.launches += 1
    return dx, dscale.to(scale.dtype), dbias.to(bias.dtype)


gn_swish_bwd.launches = 0


class GNSwishFunction(torch.autograd.Function):
    """GroupNorm+swish with a gradient: B4 forward, B8 backward from the
    stats B4 saved (their plain twins on CPU tensors).

    The kernels fill outputs made with ``torch.empty``, which carry no
    ``grad_fn``: called bare, ``gn_swish`` cuts the autograd graph on the
    card.  Every differentiable use goes through this Function."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups: int, eps: float):
        y, stats = gn_swish(x, scale, bias, num_groups, eps)
        ctx.save_for_backward(x, scale, bias, stats)
        ctx.num_groups = num_groups
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, stats = ctx.saved_tensors
        dx, dscale, dbias = gn_swish_bwd(x, g.contiguous(), scale, bias,
                                         stats, ctx.num_groups)
        return dx, dscale, dbias, None, None
