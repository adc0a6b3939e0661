"""LPIPS perceptual distance, as ``mas_tpu/losses/lpips.py``.

The input is scaled by the LPIPS shift and scale, run through a frozen
VGG16 ``features`` trunk tapped after the last ReLU of each of its five
blocks (before the pool), each tap unit-normalized over channels, the
squared difference of real and fake weighted per channel by ``lin{i}``
([C, 1], a 1x1 conv without bias), averaged over space and summed over
the taps: one distance per image.  Real and fake go through VGG as one
batch.  Public tensors are NHWC; the tower runs in fp32, as the JAX one.

Weights: ``convert_torch_lpips_state`` maps a torch state_dict in the
torchvision layout (``features.{i}.*``) or the reference LPIPS layout
(``vgg.slice{k}.{i}.*`` + ``lin{k}.model.1.weight``) onto this module's
keys (``vgg.conv{b}_{l}.*``, ``lin{i}``); conv kernels stay OIHW.  Absent
a checkpoint the tower takes a seeded random init; nothing is downloaded.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch import nn
from torch.nn import functional as F

# torchvision vgg16.features conv plan: (out_channels, convs per block)
_VGG_PLAN: Tuple[Tuple[int, int], ...] = (
    (64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
_LPIPS_CHANNELS = (64, 128, 256, 512, 512)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
# torchvision vgg16 ``features`` index of each conv, in block order
_TORCH_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def _conv_names() -> List[str]:
    return [f"conv{b}_{l}" for b, (_, n) in enumerate(_VGG_PLAN)
            for l in range(n)]


class VGG16Features(nn.Module):
    """NCHW x -> the five LPIPS taps (NCHW)."""

    def __init__(self):
        super().__init__()
        cin = 3
        for b, (ch, n) in enumerate(_VGG_PLAN):
            for l in range(n):
                self.add_module(f"conv{b}_{l}", nn.Conv2d(cin, ch, 3,
                                                          padding=1))
                cin = ch

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for b, (_, n) in enumerate(_VGG_PLAN):
            for l in range(n):
                x = F.relu(getattr(self, f"conv{b}_{l}")(x))
            taps.append(x)
            if b < len(_VGG_PLAN) - 1:
                x = F.max_pool2d(x, 2)
        return taps


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """x / (sqrt(sum over channels of x^2) + eps), NCHW."""
    return x / (x.square().sum(dim=1, keepdim=True).sqrt() + eps)


class LPIPS(nn.Module):
    """lpips(real, fake) -> [B] perceptual distances; NHWC inputs."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, c in enumerate(_LPIPS_CHANNELS):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.ones(c, 1)))
        self.register_buffer("shift", torch.tensor(_SHIFT),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE),
                             persistent=False)

    def forward(self, real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
        b = real.shape[0]
        x = (torch.cat([real, fake]).float() - self.shift) / self.scale
        taps = self.vgg(x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last))
        total = torch.zeros(b, device=real.device)
        for i, tap in enumerate(taps):
            f = _unit_normalize(tap.float())
            diff = (f[:b] - f[b:]).square()                      # [B,C,h,w]
            lin = getattr(self, f"lin{i}")[:, 0]
            v = (diff * lin[None, :, None, None]).sum(dim=1)     # [B,h,w]
            total = total + v.mean(dim=(1, 2))
        return total


def convert_torch_lpips_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """torch state_dict (torchvision ``features.{i}`` or LPIPS
    ``vgg.slice{k}.{i}`` layout, optional ``lin{k}.model.1.weight``) ->
    ``LPIPS`` state_dict; a ``lin{i}`` missing from ``state`` is left out,
    so a strict load of the result refuses it, as the JAX package's apply
    does."""
    flat = {k: torch.as_tensor(v).detach().cpu() for k, v in state.items()}
    if any(k.startswith("vgg.slice") for k in flat):
        # vgg.slice{k}.{i}.{leaf}: i is already the features index
        flat = {(f"features.{k.split('.')[2]}.{k.split('.')[3]}"
                 if k.startswith("vgg.slice") else k): v
                for k, v in flat.items()}
    out: Dict[str, Any] = {}
    for name, idx in zip(_conv_names(), _TORCH_CONV_IDX):
        out[f"vgg.{name}.weight"] = flat[f"features.{idx}.weight"]
        out[f"vgg.{name}.bias"] = flat[f"features.{idx}.bias"]
    for i in range(len(_LPIPS_CHANNELS)):
        key = f"lin{i}.model.1.weight"                     # [1, C, 1, 1]
        if key in flat:
            out[f"lin{i}"] = flat[key].reshape(1, -1).T.contiguous()
    return out


def load_lpips_params_from_torch(path: str) -> Dict[str, Any]:
    """Read a torch checkpoint file and convert it."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return convert_torch_lpips_state(state)
