"""Normalization + activation primitives (NHWC), as ``mas_tpu/ops/norms.py``.

Statistics are fp32 whatever the input dtype, and the variance is the
two-pass mean of squared deviations.  ``group_norm_swish`` goes through
``ops/gn_swish.py::GNSwishFunction``: kernels B4 (forward) and B8
(backward) for CUDA tensors.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F


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


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, fp32 statistics and affine, rounded
    once to x's dtype — as the JAX path.

    PyTorch's fused layer norm on the fp32 upcast: three launches (the JAX
    LayerNorm is XLA-fused, not a Pallas kernel: B7 is an opt-in).  Written
    out as fp32 tensor ops it cost ~10 launches per call, which bound the
    decode step on the host (PERF.md)."""
    return F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(),
                        eps).to(x.dtype)
