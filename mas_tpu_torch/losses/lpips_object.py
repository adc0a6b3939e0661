"""Object-aware LPIPS, as ``mas_tpu/losses/lpips_object.py``: the forward
is plain LPIPS; the backward multiplies the reconstruction's gradient by a
per-pixel map that is ``object_weight`` inside any object box and 1
elsewhere.

Boxes come as a padded [B, M, 4] array (pascal_voc x0, y0, x1, y1); a
zero-area padding box covers no pixel.
"""

from __future__ import annotations

import torch


def box_weight_map(boxes: torch.Tensor, height: int, width: int,
                   object_weight: float) -> torch.Tensor:
    """boxes [B, M, 4] -> fp32 weights [B, H, W, 1]: ``object_weight``
    where a pixel lies in a box (y0 <= y < y1 and x0 <= x < x1 over float
    pixel coordinates), else 1."""
    dev = boxes.device
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    bx = boxes.float()
    x0, y0, x1, y1 = bx[..., 0], bx[..., 1], bx[..., 2], bx[..., 3]
    rows = (ys >= y0[..., None]) & (ys < y1[..., None])       # [B, M, H]
    cols = (xs >= x0[..., None]) & (xs < x1[..., None])       # [B, M, W]
    inside = (rows[:, :, :, None] & cols[:, :, None, :]).any(dim=1)
    one = torch.ones((), device=dev)
    w = torch.where(inside, one * object_weight, one)
    return w[..., None]


class ScaleGradient(torch.autograd.Function):
    """Identity forward; backward returns (g * weights in g's dtype, None)."""

    @staticmethod
    def forward(ctx, x, weights):
        ctx.save_for_backward(weights)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (weights,) = ctx.saved_tensors
        return g * weights.to(g.dtype), None


def scale_gradient(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    return ScaleGradient.apply(x, weights)


def lpips_with_object(lpips, real: torch.Tensor, fake: torch.Tensor,
                      object_boxes: torch.Tensor,
                      object_weight: float = 2.0) -> torch.Tensor:
    """LPIPS [B] of (real, fake) with the boxes' gradient weighting on
    ``fake``; ``lpips(real, fake) -> [B]``."""
    _, h, w, _ = fake.shape
    wmap = box_weight_map(object_boxes, h, w, object_weight)
    return lpips(real, scale_gradient(fake, wmap))
