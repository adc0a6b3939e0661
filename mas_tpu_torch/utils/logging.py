"""Image-grid helpers (numpy only), as in ``mas_tpu/utils/logging.py``."""

from __future__ import annotations

import os

import numpy as np


def make_grid(images: np.ndarray, nrow: int = 8,
              pad: int = 2) -> np.ndarray:
    """[N, H, W, C] in [0,1] -> one [H', W', C] grid (NHWC)."""
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nr = (n + ncol - 1) // ncol
    grid = np.zeros((nr * (h + pad) + pad, ncol * (w + pad) + pad, c),
                    np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        grid[y:y + h, x:x + w] = images[i]
    return np.clip(grid, 0.0, 1.0)


def save_image(grid: np.ndarray, path: str) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray((grid * 255).astype(np.uint8).squeeze()).save(path)
