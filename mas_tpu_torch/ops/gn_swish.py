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
writes it once with ~10 flops in between (~200 MB at the decoder's largest
[4, 256, 256, 128] bf16).  B8 reads x and g twice each and writes dx once
(~335 MB at the seg encoder's [2, 256, 256, 128] fp32).

Both are one cooperative CUDA launch in three phases around two grid
barriers (``csrc/gn_swish_fwd.cu``, ``csrc/gn_swish_bwd.cu``, sharing the
item map and the vector loads of ``csrc/gn_swish.cuh``): a grid of the
blocks that can be resident at once walks x (and g) once for per-slice
partials, merges them across all blocks after a grid barrier, and after a
second barrier walks its rows again in reverse order, so that the rows
read last in the first walk, still in the L2, are read first.  B4's
partials are each channel's (mean, M2) over a slice of an image's rows,
merged by Chan's parallel-variance formula, never E[x^2] - mean^2, which
cancels for bf16 inputs with a large mean; its grid is capped so that a
slice holds a round of rows for every thread, and an image of few rows
(the decoder's small calls) takes slabs of whole groups whose blocks
compute their own stats, with no barrier.  B8's partials are the sums of
its closed form.
No atomics: the sums follow a fixed order, so two calls on one card give
equal bits.  Any C that the groups divide: C not a multiple of a thread's
channels takes an instance with element loads.  The host path is a
ctypes call on the current stream's raw handle (``_build.stream``).
"""

from __future__ import annotations

import torch

from .. import _build
from .norms import _normalize, f32_param, group_norm_stats, swish

_GRID = {}      # resident blocks by (kernel, device, bf16)
_SCRATCH = {}   # scratch floats by (kernel, device, shape, groups, bf16)


def _resident(kind: str, dev: int, bf16: int) -> int:
    """B4's ("fwd") or B8's ("bwd") resident grid on cuda:dev, asked of the
    library once per device and dtype."""
    grid = _GRID.get((kind, dev, bf16))
    if grid is None:
        query = getattr(_build.library(), f"mas_gn_swish_{kind}_grid")
        grid = _GRID[kind, dev, bf16] = query(dev, bf16)
        if grid < 1:
            raise RuntimeError(f"gn_swish_{kind}: no resident grid on "
                               f"cuda:{dev}")
    return grid


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
    if num_groups < 1 or c < 1 or c % num_groups:
        raise ValueError(f"channels must be divisible by {num_groups} "
                         f"groups, got {c}")
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
    """NHWC x (contiguous, C divisible by the groups) -> (swish(GroupNorm(
    x)), stats [B, 2, G] fp32 rows (mean, rstd)).  Kernel B4 for CUDA
    tensors, plain twin for CPU tensors."""
    if x.device.type == "cpu":
        return gn_swish_plain(x, scale, bias, num_groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"gn_swish runs on cpu or cuda, got {x.device}")
    _check(x, scale, bias, num_groups)
    b, h, w, c = x.shape
    bf16 = int(x.dtype == torch.bfloat16)
    dev = x.get_device()
    lib = _build.library()
    grid = _resident("fwd", dev, bf16)
    key = ("fwd", dev, b, h * w, c, num_groups, bf16)
    scratch = _SCRATCH.get(key)
    if scratch is None:
        scratch = _SCRATCH[key] = lib.mas_gn_swish_fwd_scratch(
            b, h * w, c, num_groups, grid, bf16)
    part = torch.empty(scratch, dtype=torch.float32, device=x.device)
    stats = torch.empty((b, 2, num_groups), dtype=torch.float32,
                        device=x.device)
    out = torch.empty_like(x)
    status = lib.mas_gn_swish_fwd(
        x.data_ptr(), f32_param(scale).data_ptr(), f32_param(bias).data_ptr(),
        out.data_ptr(), stats.data_ptr(), part.data_ptr(), b, h * w, c,
        num_groups, eps, grid, bf16, _build.stream(dev))
    _build.check(status, "gn_swish")
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
    b, h, w, c = x.shape
    bf16 = int(x.dtype == torch.bfloat16)
    dev = x.get_device()
    lib = _build.library()
    grid = _resident("bwd", dev, bf16)
    key = ("bwd", dev, b, h * w, c, num_groups, bf16)
    scratch = _SCRATCH.get(key)
    if scratch is None:
        scratch = _SCRATCH[key] = lib.mas_gn_swish_bwd_scratch(
            b, h * w, c, num_groups, grid)
    work = torch.empty(scratch + 2 * c, dtype=torch.float32,
                       device=x.device)
    dscale, dbias = work[scratch:].view(2, c)
    dx = torch.empty_like(x)
    status = lib.mas_gn_swish_bwd(
        x.data_ptr(), g.data_ptr(), f32_param(scale).data_ptr(),
        f32_param(bias).data_ptr(), stats.data_ptr(), dx.data_ptr(),
        work.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), b, h * w, c,
        num_groups, 1.0 / (h * w * (c // num_groups)), grid, bf16,
        _build.stream(dev))
    _build.check(status, "gn_swish_bwd")
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
