"""Conv building blocks of the VQ decoder, as ``mas_tpu/models/layers.py``.

Public tensors are NHWC like the JAX package; inside, activations are
NCHW tensors in the channels_last memory format, so the same memory is a
contiguous NHWC tensor for the GroupNorm+swish kernel (``x.permute(0, 2,
3, 1)`` costs no copy) and the layout cuDNN prefers for the convs.  Conv
weights keep the reference's OIHW layout and ``.weight`` names.

Conv 3x3 "SAME" is padding 1; Upsample is nearest 2x then a 3x3 conv;
AttnBlock is plain matmul -> fp32 softmax -> matmul, as the JAX einsums.
Downsample and SyncBatchNorm are encode-side (ROADMAP A7).
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
    """GroupNorm(32, eps=1e-6) then swish; kernel B4 on CUDA."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = group_norm_swish(_nhwc(x).contiguous(), self.weight, self.bias,
                             self.num_groups, self.eps)
        return _nchw(y)


class GroupNorm(_Norm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nchw(group_norm(_nhwc(x), self.weight, self.bias,
                                self.num_groups, self.eps))


def conv(cin: int, cout: int, kernel: int = 3) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, padding=kernel // 2)


class ResnetBlock(nn.Module):
    """GN->swish->conv3x3 twice, 1x1 ``nin_shortcut`` on channel change."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = GroupNormSwish(cin)
        self.conv1 = conv(cin, cout)
        self.norm2 = GroupNormSwish(cout)
        self.conv2 = conv(cout, cout)
        self.nin_shortcut = conv(cin, cout, 1) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
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
