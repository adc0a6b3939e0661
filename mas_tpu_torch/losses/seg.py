"""VQ-SEG loss: weighted binary cross-entropy + codebook loss, as
``mas_tpu/losses/seg.py``: BCE-with-logits over the 159 channels with
``pos_weight`` 20 on the five face channels [153, 158), mean-reduced, plus
``codebook_weight * q_loss``.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from ..utils.config import SegLossConfig


def weighted_bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                             pos_weight: torch.Tensor) -> torch.Tensor:
    """mean of -(w t log sigmoid(x) + (1 - t) log(1 - sigmoid(x))) in fp32;
    logits/targets [..., C], pos_weight [C]."""
    return F.binary_cross_entropy_with_logits(
        logits.float(), targets.float(), pos_weight=pos_weight.float())


def pos_weight(cfg: SegLossConfig, device=None) -> torch.Tensor:
    w = torch.ones(cfg.image_channels, device=device)
    w[cfg.face_channel_start:cfg.face_channel_end] = cfg.face_weight
    return w


def bce_loss_with_quant(q_loss: torch.Tensor, targets: torch.Tensor,
                        logits: torch.Tensor,
                        cfg: SegLossConfig = SegLossConfig()) -> torch.Tensor:
    """targets/logits [B, H, W, C] (NHWC)."""
    bce = weighted_bce_with_logits(logits, targets,
                                   pos_weight(cfg, logits.device))
    return bce + cfg.codebook_weight * q_loss.float()
