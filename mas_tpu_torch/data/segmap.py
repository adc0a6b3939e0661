"""The 159-channel one-hot segmentation map, as ``mas_tpu/data/segmap.py``.

Channels: [0, 133) panoptic classes, [133, 153) human parts, [153, 158)
face parts, 158 edges (panoptic + human edges summed, so values can reach
2).  ``assemble_seg_map`` / ``assemble_seg_map_into`` build one map in
numpy for the input pipeline; ``one_hot_seg`` builds it with torch on the
labels' device, and ``one_hot_seg_packed`` from packed int16 label maps
[..., H, W, 4] (panoptic, human, face, edge).  Boxes are sanitized and
padded here too, and instance maps give edges.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import torch
from torch.nn import functional as F

NUM_PANOPTIC = 133
NUM_HUMAN = 20
NUM_FACE = 5
NUM_SEG_CHANNELS = NUM_PANOPTIC + NUM_HUMAN + NUM_FACE + 1   # 159

PANOPTIC_SLICE = slice(0, NUM_PANOPTIC)
HUMAN_SLICE = slice(NUM_PANOPTIC, NUM_PANOPTIC + NUM_HUMAN)
FACE_SLICE = slice(NUM_PANOPTIC + NUM_HUMAN,
                   NUM_PANOPTIC + NUM_HUMAN + NUM_FACE)
EDGE_CHANNEL = NUM_SEG_CHANNELS - 1


def assemble_seg_map(seg_panoptic: np.ndarray, edge_panoptic: np.ndarray,
                     seg_human: np.ndarray, edge_human: np.ndarray,
                     seg_face: np.ndarray) -> np.ndarray:
    """Label maps [H, W] -> [H, W, 159] float32 one-hot seg map.

    seg_panoptic in [-1, 133) and seg_human in [-1, 20), -1 = unlabeled;
    seg_face in [0, 6), 0 = background; edges binary."""
    h, w = np.asarray(seg_panoptic).shape
    out = np.zeros((h, w, NUM_SEG_CHANNELS), np.float32)
    assemble_seg_map_into(out, seg_panoptic, edge_panoptic, seg_human,
                          edge_human, seg_face, zero=False)
    return out


def assemble_seg_map_into(out: np.ndarray, seg_panoptic, edge_panoptic,
                          seg_human, edge_human, seg_face,
                          zero: bool = True, prev=None):
    """``assemble_seg_map`` written into ``out`` [H, W, 159] in place, so
    an input pipeline can reuse warm buffers.  Returns the (pixel,
    channel) indices set to 1; passed back as ``prev`` on the next use of
    the same buffer, only those are cleared instead of the whole buffer
    (``zero``).  The edge channel is rewritten every call."""
    h, w = np.asarray(seg_panoptic).shape
    flat = out.reshape(h * w, NUM_SEG_CHANNELS)
    if prev is not None:
        flat[prev[0], prev[1]] = 0.0
    elif zero:
        flat.fill(0.0)
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
    return rows, chans


def one_hot_seg(seg_panoptic: torch.Tensor, edge_panoptic: torch.Tensor,
                seg_human: torch.Tensor, edge_human: torch.Tensor,
                seg_face: torch.Tensor) -> torch.Tensor:
    """``assemble_seg_map`` in torch, on the labels' device:
    [..., H, W] label maps -> [..., H, W, 159] float32."""
    def one_hot(labels, n):     # label 0 maps to all zeros
        return F.one_hot(labels.long(), n + 1)[..., 1:].float()

    edges = edge_panoptic.float() + edge_human.float()
    return torch.cat([one_hot(seg_panoptic + 1, NUM_PANOPTIC),
                      one_hot(seg_human + 1, NUM_HUMAN),
                      one_hot(seg_face, NUM_FACE), edges[..., None]], dim=-1)


def one_hot_seg_packed(packed: torch.Tensor) -> torch.Tensor:
    """Packed int labels [..., H, W, 4] -> [..., H, W, 159] float32."""
    p = packed.long()
    return one_hot_seg(p[..., 0], p[..., 3], p[..., 1],
                       torch.zeros_like(p[..., 3]), p[..., 2])


def edges_from_instances(instance_map: np.ndarray) -> np.ndarray:
    """Instance-id map [H, W] -> uint8 edge map: a pixel is an edge iff a
    4-neighbour carries another id (1-px boundaries)."""
    m = np.asarray(instance_map)
    edge = np.zeros(m.shape, bool)
    edge[:-1, :] |= m[:-1, :] != m[1:, :]
    edge[1:, :] |= m[1:, :] != m[:-1, :]
    edge[:, :-1] |= m[:, :-1] != m[:, 1:]
    edge[:, 1:] |= m[:, 1:] != m[:, :-1]
    return edge.astype(np.uint8)


BoxLike = Union[Sequence[float], np.ndarray]


def sanitize_bboxes(boxes: Sequence[BoxLike], frame: int = 512,
                    min_side: int = 16) -> List[List[float]]:
    """Clamp pascal_voc boxes to [0, frame - 1]; drop empty boxes and
    boxes with a side under ``min_side``."""
    out: List[List[float]] = []
    for box in boxes:
        x0, y0, x1, y1 = [float(v) for v in box[:4]]
        x0, y0 = max(x0, 0.0), max(y0, 0.0)
        x1, y1 = min(x1, frame - 1.0), min(y1, frame - 1.0)
        if x1 <= x0 or y1 <= y0:
            continue
        if (x1 - x0) < min_side or (y1 - y0) < min_side:
            continue
        out.append([x0, y0, x1, y1])
    return out


def pad_boxes(boxes: Sequence[BoxLike], max_boxes: int) -> np.ndarray:
    """Ragged box list -> [max_boxes, 4] float32; zero rows are empty."""
    arr = np.zeros((max_boxes, 4), np.float32)
    for i, box in enumerate(boxes[:max_boxes]):
        arr[i] = np.asarray(box[:4], np.float32)
    return arr


def pack_seg_labels(seg_panoptic, edge, seg_human, seg_face) -> np.ndarray:
    """Label maps -> packed int16 [H, W, 4] (panoptic, human, face, edge),
    ``edge`` being the summed panoptic + human edges; the device expands
    it with ``one_hot_seg_packed``."""
    return np.stack([np.asarray(seg_panoptic), np.asarray(seg_human),
                     np.asarray(seg_face), np.asarray(edge)],
                    axis=-1).astype(np.int16)
