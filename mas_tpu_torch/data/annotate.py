"""Annotator geometry that defines the dataset's schema, as
``mas_tpu/data/annotate.py`` (numpy only).  The annotator networks
themselves (panoptic segmentation, human parsing, face landmarks) are
not part of the repository: ``preprocess.py`` runs synthetic or
user-supplied TorchScript stand-ins around this geometry.

  * ``masks_to_boxes``: binary instance masks -> pascal_voc boxes,
  * ``panoptic_thing_boxes``: a ``1000 * class + instance`` panoptic map
    -> the boxes of its "thing" instances (class < 80),
  * ``draw_face_mask`` / ``faces_to_mask``: 68-point face landmarks ->
    per-class closed 1-px contours (eyes and brows as two halves each),
  * the human-parsing transforms: ``prepare_human_input`` (bilinear resize
    to the 473x473 net input, /255, BGR-order normalization) and
    ``human_logits_to_mask`` (bilinear upsample with align_corners,
    resize back, argmax), with ``bilinear_resize`` matching
    ``F.interpolate(mode="bilinear")`` without antialiasing.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# 68-point landmark layout (face_alignment_preprocessor.py:19-35)
BEARD, BROW, NOSE, EYE, MOUTH = 0, 1, 2, 3, 4
FACE_CLASS_RANGES: Dict[int, Tuple[int, int]] = {
    BEARD: (0, 17),
    BROW: (17, 27),
    NOSE: (27, 36),
    EYE: (36, 48),
    MOUTH: (48, 68),
}


# LIP human-parsing geometry (human_parts_preprocessor.py:34-40,51-61):
# 20 classes, 473x473 net input; normalization is applied to cv2-loaded
# (BGR) images, hence the reversed ImageNet mean/std order.
HUMAN_PARTS_CLASSES = 20
HUMAN_PARTS_INPUT_SIZE = (473, 473)
HUMAN_PARTS_MEAN = np.array([0.406, 0.456, 0.485], np.float32)
HUMAN_PARTS_STD = np.array([0.225, 0.224, 0.229], np.float32)


def _bilinear_1d_weights(n_in: int, n_out: int, align_corners: bool):
    """Source indices + lerp weights for 1-D bilinear resampling with
    torch ``F.interpolate(mode="bilinear")`` semantics: point-sampled,
    no antialiasing, as the reference's torchvision resize of tensors."""
    out = np.arange(n_out, dtype=np.float64)
    if align_corners:
        src = out * ((n_in - 1) / (n_out - 1)) if n_out > 1 else out * 0.0
    else:
        src = np.clip((out + 0.5) * (n_in / n_out) - 0.5, 0.0, None)
    lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
    hi = np.clip(lo + 1, 0, n_in - 1)
    w_hi = (src - lo).astype(np.float32)
    return lo, hi, w_hi


def bilinear_resize(img: np.ndarray, out_h: int, out_w: int,
                    align_corners: bool = False) -> np.ndarray:
    """Bilinear resize of [..., H, W] float arrays, bit-matching torch
    ``F.interpolate(mode="bilinear", align_corners=...)`` / torchvision
    tensor resize."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[-2], img.shape[-1]
    ylo, yhi, wy = _bilinear_1d_weights(h, out_h, align_corners)
    xlo, xhi, wx = _bilinear_1d_weights(w, out_w, align_corners)
    rows_lo, rows_hi = img[..., ylo, :], img[..., yhi, :]
    rows = rows_lo + (rows_hi - rows_lo) * wy[:, None]     # [..., out_h, W]
    cols_lo, cols_hi = rows[..., :, xlo], rows[..., :, xhi]
    return cols_lo + (cols_hi - cols_lo) * wx


def prepare_human_input(imgs: np.ndarray) -> np.ndarray:
    """[B, 3(BGR), H, W] 0..255 float images -> the LIP net input
    [B, 3, 473, 473] (``human_parts_preprocessor.py:90-92``: torchvision
    bilinear resize, /255, Normalize with the BGR-order mean/std)."""
    x = bilinear_resize(np.asarray(imgs, np.float32),
                        *HUMAN_PARTS_INPUT_SIZE, align_corners=False)
    x = x / 255.0
    return ((x - HUMAN_PARTS_MEAN[:, None, None])
            / HUMAN_PARTS_STD[:, None, None])


def human_logits_to_mask(logits: np.ndarray, h: int, w: int) -> np.ndarray:
    """Net logits [B, 20, h', w'] -> uint8 part masks [B, H, W]
    (``human_parts_preprocessor.py:96-101``): bilinear upsample to 473x473
    with align_corners=True, torchvision resize back to the original frame
    (align_corners=False), argmax over the 20 LIP classes."""
    up = bilinear_resize(np.asarray(logits, np.float32),
                         *HUMAN_PARTS_INPUT_SIZE, align_corners=True)
    back = bilinear_resize(up, h, w, align_corners=False)
    return np.argmax(back, axis=-3).astype(np.uint8)


def masks_to_boxes(masks: np.ndarray) -> np.ndarray:
    """[N, H, W] binary masks -> [N, 4] float32 (xmin, ymin, xmax, ymax).

    Vectorized port of the loopy reference (detectron2_preprocessor.py:
    16-29).  Empty input -> [0, 4].  All-zero masks (the reference would
    crash on ``torch.min`` of an empty tensor) yield a zero row.
    """
    masks = np.asarray(masks)
    if masks.size == 0:
        return np.zeros((0, 4), np.float32)
    n, h, w = masks.shape
    nz = masks != 0
    any_row = nz.any(axis=2)                      # [N, H]
    any_col = nz.any(axis=1)                      # [N, W]
    ys = np.arange(h)[None, :]
    xs = np.arange(w)[None, :]
    big = np.iinfo(np.int64).max
    y_min = np.where(any_row, ys, big).min(axis=1)
    y_max = np.where(any_row, ys, -1).max(axis=1)
    x_min = np.where(any_col, xs, big).min(axis=1)
    x_max = np.where(any_col, xs, -1).max(axis=1)
    empty = ~nz.any(axis=(1, 2))
    boxes = np.stack([x_min, y_min, x_max, y_max], axis=1).astype(np.float32)
    boxes[empty] = 0.0
    return boxes


def panoptic_thing_boxes(panoptic: np.ndarray) -> np.ndarray:
    """Panoptic map [H, W] of ``1000*class + instance`` ids -> boxes of
    "thing" instances (class < 80, per panopticapi;
    detectron2_preprocessor.py:79-88)."""
    panoptic = np.asarray(panoptic)
    ids = np.unique(panoptic)
    thing_ids = ids[ids < 80 * 1000]
    if thing_ids.size == 0:
        return np.zeros((0, 4), np.float32)
    masks = panoptic[None] == thing_ids[:, None, None]
    return masks_to_boxes(masks)


def _line_points(p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    """8-connected Bresenham raster of the segment p0 -> p1 (int (x, y))."""
    x0, y0 = int(p0[0]), int(p0[1])
    x1, y1 = int(p1[0]), int(p1[1])
    n = max(abs(x1 - x0), abs(y1 - y0))
    if n == 0:
        return np.array([[x0, y0]], np.int64)
    # sampling the line at n+1 uniform steps and rounding reproduces the
    # DDA/Bresenham pixel set for 8-connected lines
    t = np.arange(n + 1, dtype=np.float64) / n
    xs = np.round(x0 + t * (x1 - x0)).astype(np.int64)
    ys = np.round(y0 + t * (y1 - y0)).astype(np.int64)
    return np.stack([xs, ys], axis=1)


def draw_closed_contour(mask: np.ndarray, points: np.ndarray,
                        value: int) -> np.ndarray:
    """Rasterize a CLOSED 1-px polyline through integer (x, y) ``points``
    into ``mask`` (in place; also returned).  Out-of-frame pixels are
    clipped — the reference swallows them via IndexError/cv2 clipping."""
    points = np.asarray(points, np.int64)
    if len(points) == 0:
        return mask
    h, w = mask.shape
    segs = [_line_points(points[i], points[(i + 1) % len(points)])
            for i in range(len(points))]
    pts = np.concatenate(segs, axis=0)
    keep = ((pts[:, 0] >= 0) & (pts[:, 0] < w)
            & (pts[:, 1] >= 0) & (pts[:, 1] < h))
    pts = pts[keep]
    mask[pts[:, 1], pts[:, 0]] = value
    return mask


def draw_face_mask(mask: np.ndarray, landmarks: np.ndarray) -> np.ndarray:
    """68-point landmarks [(x, y) float] -> per-class contour labels drawn
    into ``mask`` (uint8 [H, W], in place; also returned).

    Mirrors ``draw_interpolated_face`` (face_alignment_preprocessor.py:
    103-112): one closed contour per facial part with pixel value
    ``class_id + 1``; EYE and BROW are drawn as two half-contours
    (left/right) so the eyes (or brows) are not connected to each other.
    """
    face = np.asarray(landmarks).astype(np.int64)
    for class_id, (start, stop) in FACE_CLASS_RANGES.items():
        value = class_id + 1
        if class_id in (EYE, BROW):
            step = (stop - start) // 2
            draw_closed_contour(mask, face[start:start + step], value)
            draw_closed_contour(mask, face[start + step:stop], value)
        else:
            draw_closed_contour(mask, face[start:stop], value)
    return mask


def faces_to_mask(shape: Tuple[int, int],
                  all_landmarks: np.ndarray) -> np.ndarray:
    """[F, 68, 2] landmark sets -> uint8 face seg mask [H, W]
    (the ``seg_face`` npz member format,
    face_alignment_preprocessor.py:126-133)."""
    mask = np.zeros(shape, np.uint8)
    for landmarks in np.asarray(all_landmarks).reshape(-1, 68, 2):
        draw_face_mask(mask, landmarks)
    return mask
