"""The 159-channel one-hot segmentation map, as ``mas_tpu/data/segmap.py``.

Channels: [0, 133) panoptic classes, [133, 153) human parts, [153, 158)
face parts, 158 edges (panoptic + human edges summed, so values can reach
2).  ``assemble_seg_map`` builds one map in numpy for the input pipeline;
``one_hot_seg_packed`` expands packed int16 label maps [..., H, W, 4]
(panoptic, human, face, edge) to the one-hot on the device.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

NUM_PANOPTIC = 133
NUM_HUMAN = 20
NUM_FACE = 5
NUM_SEG_CHANNELS = NUM_PANOPTIC + NUM_HUMAN + NUM_FACE + 1   # 159
EDGE_CHANNEL = NUM_SEG_CHANNELS - 1


def assemble_seg_map(seg_panoptic: np.ndarray, edge_panoptic: np.ndarray,
                     seg_human: np.ndarray, edge_human: np.ndarray,
                     seg_face: np.ndarray) -> np.ndarray:
    """Label maps [H, W] -> [H, W, 159] float32 one-hot seg map.

    seg_panoptic in [-1, 133) and seg_human in [-1, 20), -1 = unlabeled;
    seg_face in [0, 6), 0 = background; edges binary."""
    h, w = np.asarray(seg_panoptic).shape
    flat = np.zeros((h * w, NUM_SEG_CHANNELS), np.float32)
    ar = np.arange(h * w)
    pan = np.asarray(seg_panoptic).reshape(-1).astype(np.int64)
    hum = np.asarray(seg_human).reshape(-1).astype(np.int64)
    face = np.asarray(seg_face).reshape(-1).astype(np.int64)
    mp, mh, mf = pan >= 0, hum >= 0, face > 0
    rows = np.concatenate([ar[mp], ar[mh], ar[mf]])
    chans = np.concatenate([pan[mp], NUM_PANOPTIC + hum[mh],
                            NUM_PANOPTIC + NUM_HUMAN + face[mf] - 1])
    flat[rows, chans] = 1.0
    flat[:, EDGE_CHANNEL] = (np.asarray(edge_panoptic).astype(np.float32)
                             + np.asarray(edge_human)).reshape(-1)
    return flat.reshape(h, w, NUM_SEG_CHANNELS)


def one_hot_seg_packed(packed: torch.Tensor) -> torch.Tensor:
    """Packed int labels [..., H, W, 4] -> [..., H, W, 159] float32."""
    p = packed.long()

    def one_hot(labels, n):     # label 0 maps to all zeros
        return F.one_hot(labels, n + 1)[..., 1:]

    return torch.cat([one_hot(p[..., 0] + 1, NUM_PANOPTIC),
                      one_hot(p[..., 1] + 1, NUM_HUMAN),
                      one_hot(p[..., 2], NUM_FACE),
                      p[..., 3:4]], dim=-1).float()
