"""PatchGAN discriminator and the GAN loss heads, as
``mas_tpu/losses/discriminator.py``.

``PatchDiscriminator``: 4x4 convs with padding 1, stride 2 except the last
two, LeakyReLU(0.2), BatchNorm on layers 1..n_layers, ``base_filters``
(64) times min(2^n, 8) channels, a 1-channel patch logit map.  Public
tensors are NHWC; the tower runs in fp32, as the JAX one does on the fp32
reconstruction.  Init as the JAX package's: conv weights N(0, 0.02), zero
conv biases, BN scale N(1, 0.02).

BatchNorm is flax's ``nn.BatchNorm(momentum=0.9)``: 0.9 of the old
running value is kept, and the running variance is the biased batch
variance E[x^2] - mean^2 clipped at 0 (``nn.BatchNorm2d`` tracks the
unbiased one).  ``forward(x, train, update_stats)``: the generator step
runs the tower on batch statistics and discards their update
(``update_stats=False``); the discriminator step updates them, real batch
first, then fake.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..models.layers import SyncBatchNorm


class BatchNorm(SyncBatchNorm):
    """flax ``nn.BatchNorm``: ``SyncBatchNorm`` with the batch variance
    clipped at 0."""

    def batch_stats(self, xf: torch.Tensor):
        mean, var = super().batch_stats(xf)
        return mean, var.clamp_min(0.0)


class PatchDiscriminator(nn.Module):
    """x [B, H, W, C] -> patch logits [B, H/8 - 2, W/8 - 2, 1] (n_layers 3)."""

    def __init__(self, input_channels: int = 3, base_filters: int = 64,
                 n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers
        self.conv_0 = nn.Conv2d(input_channels, base_filters, 4, 2, 1)
        cin = base_filters
        for n in range(1, n_layers + 1):
            cout = base_filters * min(2 ** n, 8)
            stride = 2 if n < n_layers else 1
            self.add_module(f"conv_{n}", nn.Conv2d(cin, cout, 4, stride, 1,
                                                   bias=False))
            self.add_module(f"bn_{n}", BatchNorm(cout))
            cin = cout
        self.conv_out = nn.Conv2d(cin, 1, 4, 1, 1)

    def init_weights_(self, generator: torch.Generator) -> None:
        """Seeded init: conv weights N(0, 0.02), biases 0, BN scale
        N(1, 0.02), BN bias 0, running statistics (0, 1)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    nn.init.normal_(m.weight, 0.0, 0.02, generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, BatchNorm):
                    nn.init.normal_(m.weight, 1.0, 0.02, generator=generator)
                    m.bias.zero_()
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        h = x.float().permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        h = F.leaky_relu(self.conv_0(h), 0.2)
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"conv_{n}")(h)
            h = getattr(self, f"bn_{n}")(h, train=train, update=update_stats)
            h = F.leaky_relu(h, 0.2)
        return self.conv_out(h).permute(0, 2, 3, 1)


def hinge_d_loss(logits_real: torch.Tensor,
                 logits_fake: torch.Tensor) -> torch.Tensor:
    """0.5 * (mean relu(1 - real) + mean relu(1 + fake))."""
    return 0.5 * (F.relu(1.0 - logits_real.float()).mean()
                  + F.relu(1.0 + logits_fake.float()).mean())


def vanilla_d_loss(logits_real: torch.Tensor,
                   logits_fake: torch.Tensor) -> torch.Tensor:
    """The non-saturating BCE variant."""
    return 0.5 * (F.softplus(-logits_real.float()).mean()
                  + F.softplus(logits_fake.float()).mean())


def generator_loss(logits_fake: torch.Tensor) -> torch.Tensor:
    """-mean D(recon)."""
    return -logits_fake.float().mean()


def adopt_weight(weight: float, step: int, threshold: int,
                 value: float = 0.0) -> float:
    """``weight`` from ``step >= threshold`` on, ``value`` before."""
    return float(weight) if step >= threshold else float(value)
