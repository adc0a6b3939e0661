"""Conv building blocks of the VQ autoencoders, as
``mas_tpu/models/layers.py``.

Public tensors are NHWC like the JAX package; inside, activations are
NCHW tensors in the channels_last memory format, so the same memory is a
contiguous NHWC tensor for the GroupNorm+swish kernel (``x.permute(0, 2,
3, 1)`` costs no copy) and the layout cuDNN prefers for the convs.  Conv
weights keep the reference's OIHW layout and ``.weight`` names.

Convs are ``Conv2d``: an ``nn.Conv2d`` that casts its weight and bias to
the input's dtype at use, so a model trained with fp32 master weights
computes in bf16 (a no-op where the weights already have that dtype).
Conv 3x3 "SAME" is padding 1; Upsample is nearest 2x then a 3x3 conv;
Downsample pads bottom/right by one, then a stride-2 VALID 3x3 conv;
AttnBlock is plain matmul -> fp32 softmax -> matmul, as the JAX einsums.
GroupNorm+swish goes through ``GNSwishFunction`` (kernels B4/B8 on CUDA).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.norms import group_norm, group_norm_swish


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class _Norm(nn.Module):
    def __init__(self, channels: int, num_groups: int = 32,
                 eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))


class GroupNormSwish(_Norm):
    """GroupNorm(32, eps=1e-6) then swish, differentiable; kernels B4
    (forward) and B8 (backward) on CUDA."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = group_norm_swish(_nhwc(x).contiguous(), self.weight, self.bias,
                             self.num_groups, self.eps)
        return _nchw(y)


class GroupNorm(_Norm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nchw(group_norm(_nhwc(x), self.weight, self.bias,
                                self.num_groups, self.eps))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in its input's dtype: weight and bias are
    cast at use."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def conv(cin: int, cout: int, kernel: int = 3) -> Conv2d:
    return Conv2d(cin, cout, kernel, padding=kernel // 2)


class ResnetBlock(nn.Module):
    """GN->swish->conv3x3 twice, 1x1 ``nin_shortcut`` on channel change;
    dropout between ``norm2`` and ``conv2`` in training mode."""

    def __init__(self, cin: int, cout: int, dropout: float = 0.0):
        super().__init__()
        self.norm1 = GroupNormSwish(cin)
        self.conv1 = conv(cin, cout)
        self.norm2 = GroupNormSwish(cout)
        self.dropout = nn.Dropout(dropout) if dropout > 0.0 else None
        self.conv2 = conv(cout, cout)
        self.nin_shortcut = conv(cin, cout, 1) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm2(self.conv1(self.norm1(x)))
        if self.dropout is not None:
            h = self.dropout(h)
        h = self.conv2(h)
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head attention over the h*w positions, with a residual."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = GroupNorm(c)
        self.q, self.k, self.v = conv(c, c, 1), conv(c, c, 1), conv(c, c, 1)
        self.proj_out = conv(c, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hn = self.norm(x)
        seq = lambda t: _nhwc(t).reshape(b, h * w, c)
        q, k, v = seq(self.q(hn)), seq(self.k(hn)), seq(self.v(hn))
        scores = torch.matmul(q.float(), k.float().transpose(1, 2))
        attn = torch.softmax(scores * (c ** -0.5), dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).to(x.dtype).reshape(b, h, w, c)
        return x + self.proj_out(
            _nchw(out).contiguous(memory_format=torch.channels_last))


class Upsample(nn.Module):
    """Nearest-neighbour 2x, then conv3x3."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = conv(c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        return self.conv(x.contiguous(memory_format=torch.channels_last))


class Downsample(nn.Module):
    """Pad bottom and right by one (none top/left), then a stride-2 VALID
    3x3 conv."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x.contiguous(memory_format=torch.channels_last))


class SyncBatchNorm(nn.Module):
    """BatchNorm over (N, H, W) of the ``quant_conv`` output, as the JAX
    ``SyncBatchNorm``: fp32 statistics, the *biased* batch variance
    E[x^2] - mean^2 in training mode, running statistics with decay 0.9
    (``nn.BatchNorm2d`` would track the unbiased variance), output in x's
    dtype.  Single process: statistics across processes wait for
    ``torch.distributed`` (ROADMAP A12).  ``num_batches_tracked`` is kept
    for the reference key layout and never read."""

    def __init__(self, c: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def batch_stats(self, xf: torch.Tensor):
        """fp32 NCHW -> per-channel (mean, biased variance)."""
        mean = xf.mean(dim=(0, 2, 3))
        return mean, xf.square().mean(dim=(0, 2, 3)) - mean.square()

    def forward(self, x: torch.Tensor, train: bool = False,
                update: bool = True) -> torch.Tensor:
        """x NCHW; ``train``: batch statistics, and with ``update`` the
        running ones updated in place."""
        xf = x.float()
        if train:
            mean, var = self.batch_stats(xf)
            if update:
                m = self.momentum
                with torch.no_grad():
                    self.running_mean.copy_(m * self.running_mean
                                            + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var
                                           + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        out = (xf - mean[:, None, None]) * inv[:, None, None] \
            + self.bias[:, None, None]
        return out.to(x.dtype)
