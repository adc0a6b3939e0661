"""Rounding of a matrix product's operands: none for the reference, fp8
for its control.

The reference computes in fp32 with TF32 off.  Its control is the same
code with every matrix product's operands rounded to fp8 (e4m3, one
scale a tensor that maps its largest magnitude to 448, as fp8 inference
scales a tensor): the nearest precision below the bf16 that the
configurations state.  The rounding passes gradients straight through,
so a control training step's backward products also take the rounded
operands.
"""

from __future__ import annotations

from typing import Callable

import torch

Rounding = Callable[[torch.Tensor], torch.Tensor]

FP8_MAX = 448.0


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under a per-tensor scale, back in fp32; the
    gradient passes through unchanged."""
    with torch.no_grad():
        scale = FP8_MAX / x.detach().abs().amax().clamp_min(1e-30)
        r = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (r - x).detach() if x.requires_grad else r


def by_name(name: str) -> Rounding:
    return {"exact": exact, "fp8": fp8}[name]


def fp32_only() -> None:
    """TF32 off: an fp32 product is an fp32 product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
