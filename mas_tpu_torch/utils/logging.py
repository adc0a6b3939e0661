"""Image-grid helpers (numpy only), the scalar logger and the seg-map
``Visualizer``, as in ``mas_tpu/utils/logging.py``."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np

# channel groups of the 159-channel seg tensor
SEG_GROUPS = {
    "panoptic": (0, 133),
    "human": (133, 153),
    "face": (153, 158),
    "edge": (158, 159),
}


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


class Logger:
    """Scalar logger: prints one JSON line per call and appends it to
    ``<log_dir>/metrics.jsonl``; every ``image_period`` steps a call with
    ``img`` and ``img_rec`` ([N, H, W, C] in [0, 1]) also saves their grid,
    inputs above reconstructions, as ``<log_dir>/samples_<step>.jpg``.
    TensorBoard is not ported yet (ROADMAP A11)."""

    def __init__(self, log_dir: str = "logs", image_period: int = 500):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self.image_period = image_period

    def log(self, step: int, img=None, img_rec=None, **scalars) -> None:
        if scalars:
            line = json.dumps({"step": step, "time": time.time(),
                               **{k: float(v) for k, v in scalars.items()}})
            print(line)
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if (img is not None and img_rec is not None
                and step % self.image_period == 0):
            grid = make_grid(np.concatenate([np.asarray(img),
                                             np.asarray(img_rec)]))
            save_image(grid, os.path.join(self.log_dir,
                                          f"samples_{step}.jpg"))


class Visualizer:
    """159-channel seg tensor -> RGB: each group through a fixed random
    [channels, 3] projection (``np.random.default_rng(seed)``, in
    ``SEG_GROUPS`` order), min-max normalized over the whole batch."""

    def __init__(self, out_dir: str = "results", seed: int = 0):
        self.out_dir = out_dir
        rng = np.random.default_rng(seed)
        self.weights = {
            key: rng.standard_normal((hi - lo, 3)).astype(np.float32)
            for key, (lo, hi) in SEG_GROUPS.items()}
        os.makedirs(out_dir, exist_ok=True)

    def colorize(self, seg: np.ndarray,
                 logits: bool = False) -> Dict[str, np.ndarray]:
        """seg [B, H, W, 159] -> {group: [B, H, W, 3] in [0, 1]}.  With
        ``logits`` each group is first the one-hot of its argmax, the
        face and edge groups masked to ``sigmoid > 0.2``."""
        seg = np.asarray(seg, np.float32)
        out = {}
        for key, (lo, hi) in SEG_GROUPS.items():
            part = seg[..., lo:hi]
            if logits:
                n_cls = part.shape[-1]
                if key in ("face", "edge"):
                    mask = (1.0 / (1.0 + np.exp(-part)) > 0.2)
                idx = np.argmax(part, axis=-1)
                part = np.eye(n_cls, dtype=np.float32)[idx]
                if key in ("face", "edge"):
                    part = part * mask
            x = part @ self.weights[key]
            span = x.max() - x.min()
            out[key] = (x - x.min()) / (span + 1e-8)
        return out

    def __call__(self, step: int, image: Optional[np.ndarray] = None,
                 seg: Optional[np.ndarray] = None,
                 seg_rec: Optional[np.ndarray] = None) -> str:
        """Save ``<out_dir>/result_<step>.jpg``: the panels [image | seg
        groups | seg_rec groups (logits)] stacked along the batch, one
        grid row per ``len(panels)`` of them."""
        panels = []
        if image is not None:
            panels.append(np.asarray(image, np.float32))
        if seg is not None:
            panels.extend(self.colorize(seg).values())
        if seg_rec is not None:
            panels.extend(self.colorize(seg_rec, logits=True).values())
        flat = np.concatenate(panels, axis=0)
        if flat.shape[-1] == 159:                     # no RGB image passed
            raise ValueError("colorize before stacking")
        path = os.path.join(self.out_dir, f"result_{step}.jpg")
        save_image(make_grid(flat, nrow=len(panels)), path)
        return path
