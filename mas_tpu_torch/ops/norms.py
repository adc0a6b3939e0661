"""Normalization + activation primitives (NHWC), as ``mas_tpu/ops/norms.py``,
and ``folded_ln_dense``, a LayerNorm folded into the next matrix product.

Statistics are fp32 whatever the input dtype, and the variance is the
two-pass mean of squared deviations.  ``group_norm_swish`` goes through
``ops/gn_swish.py::GNSwishFunction``: kernels B4 (forward) and B8
(backward) for CUDA tensors; ``layer_norm`` through kernel B7
(``ops/layer_norm.py``) on the routes ``ln_route`` gives.
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F


def f32_param(p: torch.Tensor) -> torch.Tensor:
    """A scale or bias as the B7 and B8 kernels read it: fp32."""
    return p if p.dtype == torch.float32 else p.float()


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def group_norm_stats(x: torch.Tensor, num_groups: int, eps: float):
    """NHWC x -> (mean, rstd), each fp32 [B, G]; two-pass variance."""
    b, h, w, c = x.shape
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by {num_groups} groups")
    xg = x.float().reshape(b, h * w, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3))
    var = (xg - mean[:, None, :, None]).square().mean(dim=(1, 3))
    return mean, torch.rsqrt(var + eps)


def _normalize(x, mean, rstd, scale, bias):
    """fp32 (x - mean) * rstd * scale + bias, stats broadcast to channels."""
    b, h, w, c = x.shape
    g = mean.shape[1]
    xg = x.float().reshape(b, h, w, g, c // g)
    xn = ((xg - mean[:, None, None, :, None]) * rstd[:, None, None, :, None])
    return xn.reshape(b, h, w, c) * scale.float() + bias.float()


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over an NHWC tensor; output in x's dtype."""
    mean, rstd = group_norm_stats(x, num_groups, eps)
    return _normalize(x, mean, rstd, scale, bias).to(x.dtype)


def group_norm_swish(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     num_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """Fused GroupNorm -> swish over NHWC, differentiable; kernels B4/B8
    for CUDA tensors."""
    from .gn_swish import GNSwishFunction

    return GNSwishFunction.apply(x, scale, bias, num_groups, eps)


# B7's widest row (``csrc/layer_norm.cu``: eight warps of up to eight
# 16-byte vectors a thread)
B7_MAX_D = 8192

# layer_norm's routes: B7 through ``LayerNormFunction`` (one launch
# forward), the fp32 upcast chain (three)
LN_ROUTES = ("b7", "upcast")


def ln_kernel_shape(shape) -> bool:
    """The JAX package's rule for its fused LayerNorm
    (``mas_tpu/ops/pallas/layer_norm.py::_supported``): at least 4096 rows
    and a last axis that is a multiple of 128."""
    d = shape[-1]
    return len(shape) >= 2 and d % 128 == 0 and math.prod(shape) // d >= 4096


def ln_route(device_type: str, grad_enabled: bool, impl: str, shape,
             dtype: torch.dtype) -> str:
    """The route of a LayerNorm over the last axis of a ``shape`` tensor
    (one of ``LN_ROUTES``), from what the call observes.

    On the card with autograd recording nothing (``sample_images``'
    inference mode, a decode step's capture, evaluation under
    ``no_grad``), B7 at any row count, whatever ``impl`` says: its forward
    reads x once, keeps the fp32 two-pass statistics and affine and rounds
    once, the upcast chain's arithmetic in one launch.  Every other call
    keeps the rule it had: B7 for ``impl='pallas'`` and shapes that meet
    ``ln_kernel_shape``, else the upcast chain.  That rule stays for the
    training step because B7 there made no measured difference to a step
    paced by the host (CHANGES.md, B7's CUDA redesign), and CPU calls keep
    it so that they compute what the JAX package does."""
    if device_type == "cuda" and not grad_enabled:
        kernel = (shape[-1] <= B7_MAX_D
                  and dtype in (torch.bfloat16, torch.float32))
    else:
        kernel = impl == "pallas" and ln_kernel_shape(shape)
    return "b7" if kernel else "upcast"


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5, impl: str = "jnp") -> torch.Tensor:
    """LayerNorm over the last axis, fp32 statistics and affine, rounded
    once to x's dtype — as the JAX path.

    The route is ``ln_route``'s, counted in ``layer_norm.calls`` (eager
    calls and a decode step's capture; a graph's replay counts none):
    ``"b7"`` is ``ops/layer_norm.py::LayerNormFunction``, one launch
    forward (autograd off records nothing), as the JAX package takes its
    Pallas LayerNorm with ``impl='pallas'`` (``TransformerConfig.
    layernorm_impl``); ``"upcast"`` is PyTorch's fused layer norm on the
    fp32 upcast: three launches.  Written out as fp32 tensor ops it cost
    ~10 launches per call, which bound the decode step on the host
    (PERF.md)."""
    if impl not in ("jnp", "pallas"):
        raise ValueError(f"impl must be jnp/pallas, got {impl!r}")
    route = ln_route(x.device.type, torch.is_grad_enabled(), impl, x.shape,
                     x.dtype)
    layer_norm.calls[route] += 1
    if route == "b7":
        from .layer_norm import LayerNormFunction

        return LayerNormFunction.apply(x, scale, bias, eps)
    return F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(),
                        eps).to(x.dtype)


layer_norm.calls = dict.fromkeys(LN_ROUTES, 0)


def folded_ln_dense(x: torch.Tensor, ln_scale: torch.Tensor,
                    ln_bias: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float,
                    dtype: torch.dtype) -> torch.Tensor:
    """``Dense(LayerNorm(x))`` without the normalized tensor
    (``mas_tpu/ops/norms.py::folded_ln_dense``): with row statistics mu and
    r = rsqrt(var + eps) in fp32,

        LN(x) W^T + b = r (x (gamma W)^T) - r mu colsum + W beta + b,

    colsum_j = sum_i gamma_i W_ji.  ``weight`` is the torch layout [out,
    in]; gamma W is rounded once to ``dtype``, the product runs in
    ``dtype`` (a plain matrix product, as JAX leaves it to XLA) and the
    epilogue in fp32; the result is rounded to ``dtype``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    wf = weight.float()
    wg = wf * ln_scale.float()[None, :]             # [out, in]
    colsum = wg.sum(dim=1)                          # [out]
    beta_w = wf @ ln_bias.float()                   # [out]
    y = F.linear(x.to(dtype), wg.to(dtype))
    return (y.float() * r - (r * mu) * colsum + beta_w
            + bias.float()).to(dtype)
