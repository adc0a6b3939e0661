"""LayerNorm over the last axis: forward and backward (kernel B7), and
``LayerNormFunction``, which joins them for autograd.

B7 replaces ``mas_tpu/ops/pallas/layer_norm.py::_fwd_kernel`` and
``_bwd_kernel`` (launched by ``_ln_fwd_pallas`` / ``_ln_bwd_pallas``
under ``ln_pallas``), the opt-in ``layernorm_impl: "pallas"`` LayerNorm of
the transformer.  Same semantics: fp32 statistics whatever the input
dtype, biased variance, eps inside the rsqrt; the forward returns
(x - mean) * rstd * scale + bias in x's dtype, the backward recomputes
mean and rstd from x (nothing is saved but x) and returns

  dx = rstd * (g s - mean(g s) - x^ mean(g s x^)),  x^ = (x - mean) rstd

(means over the row) in x's dtype, dscale = sum g x^ and dbias = sum g over
all rows in fp32.

What bounds both on the H100: bytes.  At the train step's [11264, 1024]
bf16 the forward reads and writes 23 MB each, the backward reads x and g
and writes dx, with ~10 flops per element in between.  The training step
waits for the host, so each launch's host time counts as well.

B7 is ``csrc/layer_norm.cu``: one launch each way, a row in registers (a
warp, four or eight warps a row by d), and a backward whose blocks each
own 24 rows and write one [2, d] fp32 partial of dscale and dbias; the
last blocks to finish (ticket counters in device memory) sum the
partials in a fixed order, so two calls give equal bits.  The host path is
a ctypes call on the current stream's raw handle (``_build.stream``).  The
backward's geometry lives in the C library: it says how many partials a
call needs (``mas_layer_norm_bwd_scratch``), which each call allocates
(stream-ordered, and from the graph's own pool under CUDA-graph capture).
Only the ticket counters are kept, per device and stream (``_tickets``),
and every launch leaves them at zero, so a CUDA graph can hold the
backward.
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from .norms import f32_param

_TICKETS = {}   # (device, stream) -> the backward's ticket counters


def _stats(xf: torch.Tensor, eps: float):
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    return xc, torch.rsqrt(xc.square().mean(dim=-1, keepdim=True) + eps)


def layer_norm_fwd_plain(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, eps: float = 1e-5):
    """Plain twin of the B7 forward: x [N, d] -> LayerNorm(x) in x's
    dtype, fp32 two-pass statistics and affine."""
    xc, rstd = _stats(x.float(), eps)
    return (xc * rstd * scale.float() + bias.float()).to(x.dtype)


def layer_norm_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                         scale: torch.Tensor, eps: float = 1e-5):
    """Plain twin of the B7 backward: (dx in x's dtype, dscale, dbias in
    fp32) from x, the output gradient g [N, d] and scale."""
    xc, rstd = _stats(x.float(), eps)
    xhat = xc * rstd
    gf = g.float()
    gs = gf * scale.float()
    dx = rstd * (gs - gs.mean(dim=-1, keepdim=True)
                 - xhat * (gs * xhat).mean(dim=-1, keepdim=True))
    return dx.to(x.dtype), (gf * xhat).sum(dim=0), gf.sum(dim=0)


def _check(x, scale, bias=None, g=None):
    if x.dim() != 2:
        raise ValueError(f"x must be [N, d], got shape {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bf16 or fp32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    d = x.shape[1]
    if d > 8192:
        raise ValueError(f"layer_norm kernel takes d <= 8192, got {d}")
    dev = x.get_device()   # an int: cheaper to compare than device objects
    for name, p in (("scale", scale), ("bias", bias)):
        if p is None:
            continue
        if p.shape != (d,) or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [{d}] tensor")
        if p.get_device() != dev:
            raise ValueError(f"{name} is on {p.device}, x on {x.device}")
    if g is not None and (g.shape != x.shape or g.dtype != x.dtype
                          or not g.is_contiguous() or g.get_device() != dev):
        raise ValueError(f"g must be a contiguous {x.dtype} "
                         f"{tuple(x.shape)} tensor on {x.device}, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")


@functools.lru_cache(maxsize=None)
def _scratch_floats(n: int, d: int) -> int:
    return _build.library().mas_layer_norm_bwd_scratch(n, d)


def _tickets(device_index: int, stream: int) -> torch.Tensor:
    """The backward's ticket counters for one device and stream, zeroed
    once and kept: launches on one stream take turns with them, each leaves
    them at zero (the last block of each level resets its counter), and a
    CUDA graph replays them."""
    key = (device_index, stream)
    kept = _TICKETS.get(key)
    if kept is None:
        kept = torch.zeros(_build.library().mas_layer_norm_bwd_tickets(),
                           dtype=torch.int32,
                           device=torch.device("cuda", device_index))
        _TICKETS[key] = kept
    return kept


def layer_norm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of contiguous rows x [N, d] in x's dtype.  Kernel B7 for
    CUDA tensors, plain twin for CPU tensors."""
    if x.device.type == "cpu":
        return layer_norm_fwd_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_fwd runs on cpu or cuda, got "
                         f"{x.device}")
    _check(x, scale, bias)
    n, d = x.shape
    y = torch.empty_like(x)
    if n:
        status = _build.library().mas_layer_norm_fwd(
            x.data_ptr(), f32_param(scale).data_ptr(),
            f32_param(bias).data_ptr(), y.data_ptr(), n, d, eps,
            int(x.dtype == torch.bfloat16),
            _build.stream(x.get_device()))
        _build.check(status, "layer_norm_fwd")
        layer_norm_fwd.launches += 1
    return y


layer_norm_fwd.launches = 0


def layer_norm_bwd(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5):
    """Backward of ``layer_norm_fwd`` -> (dx in x's dtype, dscale, dbias in
    fp32).  Kernel B7 for CUDA tensors, plain twin for CPU tensors."""
    if x.device.type == "cpu":
        return layer_norm_bwd_plain(x, g, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_bwd runs on cpu or cuda, got "
                         f"{x.device}")
    _check(x, scale, g=g)
    n, d = x.shape
    dx = torch.empty_like(x)
    sums = (torch.zeros if n == 0 else torch.empty)(
        2 * d, dtype=torch.float32, device=x.device)
    if n:
        dev = x.get_device()
        stream = _build.stream(dev)
        part = torch.empty(_scratch_floats(n, d), dtype=torch.float32,
                           device=x.device)
        ptr = sums.data_ptr()
        status = _build.library().mas_layer_norm_bwd(
            x.data_ptr(), g.data_ptr(), f32_param(scale).data_ptr(),
            dx.data_ptr(), part.data_ptr(), _tickets(dev, stream).data_ptr(),
            ptr, ptr + 4 * d, n, d, eps, int(x.dtype == torch.bfloat16),
            stream)
        _build.check(status, "layer_norm_bwd")
        layer_norm_bwd.launches += 1
    dscale, dbias = sums.view(2, d).unbind(0)
    return dx, dscale, dbias


layer_norm_bwd.launches = 0


class LayerNormFunction(torch.autograd.Function):
    """LayerNorm over the last axis with a gradient: B7 forward and
    backward (their plain twins on CPU tensors); saves x and scale only.

    The kernels fill outputs made with ``torch.empty``, which carry no
    ``grad_fn``: every differentiable use goes through this Function."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        y = layer_norm_fwd(x2, scale, bias, eps)
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(x2, scale)
        ctx.eps = eps
        ctx.dtypes = (scale.dtype, bias.dtype)
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, g):
        x2, scale = ctx.saved_tensors
        g2 = g.reshape(x2.shape).contiguous()
        dx, dscale, dbias = layer_norm_bwd(x2, g2, scale, ctx.eps)
        return (dx.view(g.shape), dscale.to(ctx.dtypes[0]),
                dbias.to(ctx.dtypes[1]), None)
