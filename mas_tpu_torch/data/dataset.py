"""Synthetic training batches, as ``mas_tpu/data/dataset.py``: the same
numpy draws from the same seed give the same batches."""

from __future__ import annotations

import numpy as np

from .segmap import assemble_seg_map


class SyntheticSegBatches:
    """Random 159-channel one-hot seg batches (VQ-SEG stage)."""

    def __init__(self, batch_size: int, resolution: int = 256, seed: int = 0):
        self.batch_size = batch_size
        self.resolution = resolution
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        while True:
            b, r = self.batch_size, self.resolution
            pan = self.rng.integers(-1, 133, (b, r, r))
            hum = self.rng.integers(-1, 20, (b, r, r))
            face = self.rng.integers(0, 6, (b, r, r))
            edge = self.rng.integers(0, 2, (b, r, r))
            zero = np.zeros((b, r, r), np.int64)
            mask = np.stack([
                assemble_seg_map(pan[i], edge[i], hum[i], zero[i], face[i])
                for i in range(b)])
            yield {"mask": mask.astype(np.float32)}


class SyntheticImgBatches:
    """Random RGB images with padded face/object boxes (VQ-IMG stage):
    ``image`` [B, r, r, 3] fp32 in [0, 1), ``bbox_obj`` = ``bbox_face``
    [B, max_boxes, 4] (x0, y0, x1, y1), 0 to ``max_boxes`` square boxes
    per image, the rest all-zero."""

    def __init__(self, batch_size: int, resolution: int = 256,
                 max_boxes: int = 6, seed: int = 0):
        self.batch_size = batch_size
        self.resolution = resolution
        self.max_boxes = max_boxes
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        b, r, m = self.batch_size, self.resolution, self.max_boxes
        while True:
            img = self.rng.random((b, r, r, 3), np.float32)
            boxes = np.zeros((b, m, 4), np.float32)
            n = self.rng.integers(0, m + 1, (b,))
            min_side = min(24, max(r // 2, 1))
            for i in range(b):
                for j in range(int(n[i])):
                    x0 = int(self.rng.integers(0, max(r - min_side, 1)))
                    y0 = int(self.rng.integers(0, max(r - min_side, 1)))
                    hi = max(min(96, r - max(x0, y0)), min_side + 1)
                    side = int(self.rng.integers(min_side, hi))
                    boxes[i, j] = (x0, y0, x0 + side, y0 + side)
            yield {"image": img, "bbox_obj": boxes, "bbox_face": boxes.copy()}


class SyntheticTokenBatches:
    """Random (text, seg, image) token batches (transformer stage)."""

    def __init__(self, batch_size: int, cfg, seed: int = 0):
        self.batch_size = batch_size
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        cfg, b = self.cfg, self.batch_size
        while True:
            yield {
                "text": self.rng.integers(
                    0, cfg.text_vocab_size - cfg.text_length,
                    (b, cfg.text_length), dtype=np.int32),
                "seg": self.rng.integers(0, cfg.seg_vocab_size,
                                         (b, cfg.seg_length), dtype=np.int32),
                "image": self.rng.integers(
                    0, cfg.image_vocab_size, (b, cfg.image_length),
                    dtype=np.int32),
            }
