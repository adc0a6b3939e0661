"""Face-feature loss, as ``mas_tpu/losses/face_loss.py``.

Each face box is cropped from the image and from the reconstruction,
resized (smaller side 256) and center-cropped to 254 in one bilinear
resample, and both go through a frozen VGGFace2 ResNet50 (Bottleneck
layers [3, 4, 6, 3], the stride on the first 1x1 conv).  The loss is
sum over its five taps (conv1 before BN, layer1..layer4) of alpha_i *
|f_gt - f_rec|, meaned over C, H, W and summed over the valid faces.
Boxes come as a padded [B, M, 4] array; a zero-area box is no face, and a
batch without faces gives exactly 0.

The resample is ``jax.image.scale_and_translate(method="bilinear")``,
antialiased: where a box is larger than 256 px (s < 1) the triangle
kernel widens to 1/s.  ``F.interpolate`` and ``grid_sample`` do not do
that, so ``_resample_weights`` builds each face's [254, H] and [254, W]
weight matrices as JAX does and the crop is two batched matmuls.

The tower is frozen: its BatchNorms use their running statistics.  Its
state_dict keys are the VGGFace2-pytorch ResNet50's (``conv1``, ``bn1``,
``layer{i}.{b}.conv1`` .. ``bn3``, ``layer{i}.{b}.downsample.{0,1}``), so
``convert_torch_face_state`` only drops what the tower lacks (``fc``).
Absent a checkpoint the tower takes a seeded random init.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..models.layers import SyncBatchNorm

ALPHAS = (0.1, 0.25 * 0.01, 0.25 * 0.1, 0.25 * 0.2, 0.25 * 0.02)
FACE_SIZE = 254
_RESIZE = 256


def _bn(c: int) -> SyncBatchNorm:
    return SyncBatchNorm(c, momentum=0.9, eps=1e-5)


class Bottleneck(nn.Module):
    """1x1 (stride) -> 3x3 -> 1x1 x4 with BN and ReLU, plus the residual
    (a strided 1x1 conv + BN where ``downsample``)."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, stride, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        self.downsample = (nn.Sequential(
            nn.Conv2d(cin, planes * 4, 1, stride, bias=False),
            _bn(planes * 4)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(h + residual)


class FaceNet(nn.Module):
    """VGGFace2 ResNet50 trunk: NHWC faces -> the five loss taps (NCHW)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        cin = 64
        for i, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                 layers)):
            stride = 1 if i == 0 else 2
            stage = [Bottleneck(cin, planes, stride, downsample=True)]
            stage += [Bottleneck(planes * 4, planes)
                      for _ in range(1, blocks)]
            self.add_module(f"layer{i + 1}", nn.Sequential(*stage))
            cin = planes * 4

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = self.conv1(x.float().permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last))
        taps = [h]                                  # before BN
        h = F.relu(self.bn1(h))
        # torch MaxPool2d(3, 2, ceil_mode=True): -inf pad at (0, 1), then
        # a VALID 3x3 / 2 pool
        h = F.max_pool2d(F.pad(h, (0, 1, 0, 1), value=float("-inf")), 3, 2)
        for i in range(1, 5):
            h = getattr(self, f"layer{i}")(h)
            taps.append(h)
        return taps


def _resample_weights(n_in: int, n_out: int, scale: torch.Tensor,
                      trans: torch.Tensor) -> torch.Tensor:
    """[N] scales and translations -> [N, n_out, n_in] weights of
    ``scale_and_translate``'s antialiased triangle kernel along one axis:
    output o samples input position (o + 0.5 - t) / s - 0.5 with a kernel
    of width max(1/s, 1); each row is normalized, and a row whose sample
    falls outside the input is 0."""
    inv = 1.0 / scale
    kscale = inv.clamp_min(1.0)
    out = torch.arange(n_out, dtype=torch.float32, device=scale.device)
    sample = ((out[None, :] + 0.5) * inv[:, None]
              - trans[:, None] * inv[:, None] - 0.5)           # [N, out]
    pos = torch.arange(n_in, dtype=torch.float32, device=scale.device)
    x = (sample[:, :, None] - pos).abs() / kscale[:, None, None]
    w = (1.0 - x).clamp_min(0.0)
    total = w.sum(dim=2, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, :, None], w, torch.zeros_like(w))


def _box_transform(boxes: torch.Tensor, out_size: int):
    """[..., 4] boxes -> (s, ty, tx): smaller side to 256, centered on the
    ``out_size`` crop."""
    bx = boxes.float()
    x0, y0, x1, y1 = bx[..., 0], bx[..., 1], bx[..., 2], bx[..., 3]
    h_box = (y1 - y0).clamp_min(1.0)
    w_box = (x1 - x0).clamp_min(1.0)
    s = _RESIZE / torch.minimum(h_box, w_box)
    half = out_size / 2.0
    return s, half - s * (y0 + h_box / 2.0), half - s * (x0 + w_box / 2.0)


def crop_resize_face(img: torch.Tensor, box: torch.Tensor,
                     out_size: int = FACE_SIZE) -> torch.Tensor:
    """img [H, W, C], box [4] -> fp32 [out_size, out_size, C]."""
    faces, _ = gather_faces(img[None], box[None, None], out_size)
    return faces[0]


def gather_faces(images: torch.Tensor, boxes: torch.Tensor,
                 out_size: int = FACE_SIZE):
    """images [B, H, W, C], boxes [B, M, 4] -> (fp32 faces [B*M, S, S, C],
    valid [B*M]); zero-area boxes are invalid."""
    b, h, w, c = images.shape
    m = boxes.shape[1]
    s, ty, tx = (t.reshape(b * m) for t in _box_transform(boxes, out_size))
    wy = _resample_weights(h, out_size, s, ty)                # [N, S, H]
    wx = _resample_weights(w, out_size, s, tx)                # [N, S, W]
    rows = torch.bmm(wy.reshape(b, m * out_size, h),
                     images.float().reshape(b, h, w * c))     # [B, M*S, W*C]
    rows = rows.reshape(b * m, out_size, w, c)
    faces = torch.matmul(wx[:, None], rows)                   # [N, S, S, C]
    area = ((boxes[..., 2] - boxes[..., 0])
            * (boxes[..., 3] - boxes[..., 1])).reshape(b * m)
    return faces, area > 0


def face_loss(facenet, images: torch.Tensor, recon: torch.Tensor,
              boxes: torch.Tensor) -> torch.Tensor:
    """Sum over valid faces of sum_i alpha_i * mean |tap_i(gt) -
    tap_i(recon)|; ``facenet(x) -> 5 taps``, ``boxes`` [B, M, 4]."""
    faces_gt, valid = gather_faces(images, boxes)
    faces_gen, _ = gather_faces(recon, boxes)
    n = faces_gt.shape[0]
    taps = facenet(torch.cat([faces_gt, faces_gen]))
    mask = valid.float()
    total = torch.zeros((), device=images.device)
    for alpha, tap in zip(ALPHAS, taps):
        per_face = (tap[:n].float() - tap[n:].float()).abs().mean(
            dim=(1, 2, 3))
        total = total + alpha * (per_face * mask).sum()
    return total


def convert_torch_face_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """VGGFace2-pytorch ResNet50 state_dict -> ``FaceNet`` state_dict:
    the same keys without the classifier; a missing
    ``num_batches_tracked`` becomes 0."""
    out = {k: torch.as_tensor(v).detach().cpu() for k, v in state.items()
           if not k.startswith("fc.")}
    for k in list(out):
        if k.endswith(".running_mean"):
            nbt = k[:-len("running_mean")] + "num_batches_tracked"
            out.setdefault(nbt, torch.zeros((), dtype=torch.long))
    return out


def load_face_params_from_torch(path: str) -> Dict[str, Any]:
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return convert_torch_face_state(state)
