"""Normalization + activation primitives (NHWC), as ``mas_tpu/ops/norms.py``.

Statistics are fp32 whatever the input dtype, and the variance is the
two-pass mean of squared deviations.  ``group_norm_swish`` goes through
``ops/gn_swish.py::GNSwishFunction``: kernels B4 (forward) and B8
(backward) for CUDA tensors; ``layer_norm(impl='pallas')`` through
``ops/layer_norm.py::LayerNormFunction``: kernel B7.
"""

from __future__ import annotations

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


def ln_kernel_shape(x: torch.Tensor) -> bool:
    """The JAX package's rule for its fused LayerNorm
    (``mas_tpu/ops/pallas/layer_norm.py::_supported``): at least 4096 rows
    and a last axis that is a multiple of 128; smaller calls, such as the
    decode step's [B, 1, D], cost more in dispatch than they save."""
    d = x.shape[-1]
    return x.dim() >= 2 and d % 128 == 0 and x.numel() // d >= 4096


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5, impl: str = "jnp") -> torch.Tensor:
    """LayerNorm over the last axis, fp32 statistics and affine, rounded
    once to x's dtype — as the JAX path.

    ``impl='pallas'`` (``TransformerConfig.layernorm_impl``) takes kernel
    B7 through ``ops/layer_norm.py::LayerNormFunction`` for shapes that
    meet ``ln_kernel_shape``, as the JAX package takes its Pallas
    LayerNorm.  Every other call is PyTorch's fused layer norm on the fp32
    upcast: three launches.  Written out as fp32 tensor ops it cost ~10
    launches per call, which bound the decode step on the host
    (PERF.md)."""
    if impl not in ("jnp", "pallas"):
        raise ValueError(f"impl must be jnp/pallas, got {impl!r}")
    if impl == "pallas" and ln_kernel_shape(x):
        from .layer_norm import LayerNormFunction

        return LayerNormFunction.apply(x, scale, bias, eps)
    return F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(),
                        eps).to(x.dtype)
