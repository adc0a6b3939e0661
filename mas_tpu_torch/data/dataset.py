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
