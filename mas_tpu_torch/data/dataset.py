"""Datasets and batching of the three training stages, as
``mas_tpu/data/dataset.py``:

  * ``PreprocessedWebDataset`` streams samples from processed tar shards
    (``jpg`` + ``npz`` + ``txt`` members): JPEG decode, smallest-side
    resize and center crop, the 159-channel seg map, sanitized boxes,
  * ``PreprocessedLocalDataset`` indexes ``{name}_{panoptic,human,
    face}.npz`` annotator outputs beside an image dir, with a seeded
    random crop; ``URLImageDataset`` fetches its images on first use;
    ``ConcatDataset`` joins such datasets,
  * ``collate`` stacks samples with boxes padded to [B, M, 4];
    ``batch_iterator`` batches a sample stream,
  * ``Synthetic*Batches`` are seeded random batches of each stage.

Batches are dicts of numpy arrays, NHWC, images float32 in [0, 1].  The
same files, or numpy draws from the same seed, give the same batches as
the JAX package.
"""

from __future__ import annotations

import io
import itertools
import os
from typing import Dict, Iterable, Iterator, List, Sequence

import numpy as np

from .segmap import assemble_seg_map, pad_boxes, sanitize_bboxes
from .tario import expand_shards, iter_tar_samples, shard_split, \
    warn_and_continue


# --- host-side image ops (PIL) -------------------------------------------

def decode_jpg(data: bytes) -> np.ndarray:
    """JPEG or PNG bytes -> [H, W, 3] float32 in [0, 1]."""
    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("RGB")
    return np.asarray(img, np.float32) / 255.0


def smallest_max_size(img: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize so that the smaller side is ``size``."""
    from PIL import Image

    h, w = img.shape[:2]
    s = size / min(h, w)
    nh, nw = max(int(round(h * s)), size), max(int(round(w * s)), size)
    if (nh, nw) == (h, w):
        return img
    return np.asarray(
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).resize(
            (nw, nh), Image.BILINEAR), np.float32) / 255.0


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    return img[top:top + size, left:left + size]


def _shift_boxes(boxes: List[List[float]], dx: float, dy: float,
                 scale: float) -> List[List[float]]:
    return [[b[0] * scale - dx, b[1] * scale - dy,
             b[2] * scale - dx, b[3] * scale - dy] for b in boxes]


def _resize_mask_nearest(mask: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbour resize of a label map so that its smaller side
    is ``size`` (the same output size as ``smallest_max_size``)."""
    h, w = mask.shape[:2]
    s = size / min(h, w)
    nh, nw = max(int(round(h * s)), size), max(int(round(w * s)), size)
    if (nh, nw) == (h, w):
        return mask
    yi = np.clip((np.arange(nh) / s).astype(np.int64), 0, h - 1)
    xi = np.clip((np.arange(nw) / s).astype(np.int64), 0, w - 1)
    return mask[yi][:, xi]


def _boxes(arr) -> List[List[float]]:
    return [list(map(float, b)) for b in arr]


# --- processed tar shards --------------------------------------------------

class PreprocessedWebDataset:
    """Processed tar shards -> per-sample dicts (``image``, ``caption``,
    ``mask`` when ``need_seg``, ``box_things``, ``box_face``).

    Each tar sample holds ``jpg``, ``npz`` (seg_panoptic, edge_panoptic,
    seg_human, edge_human, seg_face, box_things, box_face) and ``txt``
    members, as ``preprocess.py`` writes them.  The shards of this
    process (``shard_split``) are read in order; the decode and the seg
    map run on ``workers`` threads (0: inline), in order.  Samples
    without a ``jpg`` or ``npz``, and samples whose processing raises
    where ``handler`` returns True, are skipped.
    """

    def __init__(self, shards, resolution: int = 512,
                 process_index: int = 0, process_count: int = 1,
                 need_seg: bool = True, handler=warn_and_continue,
                 workers: int = 4):
        self.shards = expand_shards(shards)
        self.resolution = resolution
        self.process_index = process_index
        self.process_count = process_count
        self.need_seg = need_seg
        self.handler = handler
        self.workers = workers

    def _process(self, raw: Dict[str, bytes]) -> Dict[str, object]:
        res = self.resolution
        img = decode_jpg(raw["jpg"])
        h0, w0 = img.shape[:2]
        scale = res / min(h0, w0)
        img = center_crop(smallest_max_size(img, res), res)
        nh, nw = int(round(h0 * scale)), int(round(w0 * scale))
        dy, dx = (nh - res) / 2.0, (nw - res) / 2.0

        npz = np.load(io.BytesIO(raw["npz"]), allow_pickle=False)
        sample: Dict[str, object] = {
            "image": img,
            "caption": raw.get("txt", b"").decode("utf-8", "replace"),
        }
        if self.need_seg:
            # resize and crop the compact label maps, then assemble at the
            # target size: nearest resizing commutes with the one-hot, and
            # no [H0, W0, 159] map is built at the source size
            def prep(lab):
                return center_crop(
                    _resize_mask_nearest(np.asarray(lab), res), res)

            sample["mask"] = assemble_seg_map(
                prep(npz["seg_panoptic"]), prep(npz["edge_panoptic"]),
                prep(npz["seg_human"]), prep(npz["edge_human"]),
                prep(npz["seg_face"]))
        sample["box_things"] = sanitize_bboxes(
            _shift_boxes(_boxes(npz["box_things"]), dx, dy, scale),
            frame=res)
        sample["box_face"] = sanitize_bboxes(
            _shift_boxes(_boxes(npz["box_face"]), dx, dy, scale), frame=res)
        return sample

    def _safe_process(self, raw: Dict[str, bytes]):
        """None = skip (missing members or handled error)."""
        try:
            if "jpg" not in raw or "npz" not in raw:
                return None
            return self._process(raw)
        except Exception as exn:                      # noqa: BLE001
            if self.handler(exn):
                return None
            raise

    def __iter__(self) -> Iterator[Dict[str, object]]:
        from .prefetch import parallel_map

        shards = shard_split(self.shards, self.process_index,
                             self.process_count)

        def raws():
            for shard in shards:
                yield from iter_tar_samples(shard, handler=self.handler)

        for sample in parallel_map(self._safe_process, raws(),
                                   workers=self.workers):
            if sample is not None:
                yield sample


# --- per-image npz annotations ----------------------------------------------

class PreprocessedLocalDataset:
    """Map-style dataset over ``{preprocessed_dir}/{name}_{kind}.npz``
    annotator outputs and ``{image_dir}/{name}.{jpg,jpeg,png}``, resized
    so that the smaller side is ``resolution`` and randomly cropped to
    ``resolution``² (crop offsets from ``default_rng(seed)``)."""

    def __init__(self, image_dir: str, preprocessed_dir: str,
                 resolution: int = 256, seed: int = 0):
        self.image_dir = image_dir
        self.pre = preprocessed_dir
        self.resolution = resolution
        self.rng = np.random.default_rng(seed)
        self.names = sorted({f[:-len("_panoptic.npz")]
                             for f in os.listdir(preprocessed_dir)
                             if f.endswith("_panoptic.npz")})

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, idx: int) -> Dict[str, object]:
        name = self.names[idx]
        pan = np.load(os.path.join(self.pre, f"{name}_panoptic.npz"))
        hum = np.load(os.path.join(self.pre, f"{name}_human.npz"))
        face = np.load(os.path.join(self.pre, f"{name}_face.npz"))
        mask = assemble_seg_map(pan["seg_panoptic"], pan["edges"],
                                hum["seg_human"], hum["edges"],
                                face["seg_face"])
        img_path = next((p for p in (os.path.join(self.image_dir, name + ext)
                                     for ext in (".jpg", ".jpeg", ".png"))
                         if os.path.exists(p)), None)
        if img_path is None:
            raise FileNotFoundError(f"no image for {name}")
        with open(img_path, "rb") as f:
            img = decode_jpg(f.read())

        res = self.resolution
        h0 = img.shape[0]
        img = smallest_max_size(img, res)
        mask = _resize_mask_nearest(mask, res)
        scale = img.shape[0] / h0
        h, w = img.shape[:2]
        top = int(self.rng.integers(0, h - res + 1))
        left = int(self.rng.integers(0, w - res + 1))
        img = img[top:top + res, left:left + res]
        mask = mask[top:top + res, left:left + res]
        boxes_t = _shift_boxes(_boxes(pan["box_things"]), left, top, scale)
        boxes_f = _shift_boxes(_boxes(face["box_face"]), left, top, scale)
        return dict(image=img, mask=mask,
                    box_things=sanitize_bboxes(boxes_t, frame=res),
                    box_face=sanitize_bboxes(boxes_f, frame=res),
                    caption=name)


class URLImageDataset(PreprocessedLocalDataset):
    """``PreprocessedLocalDataset`` whose images are fetched from a URL on
    first use and cached in ``image_dir``; a failed fetch is printed and
    the item then raises ``FileNotFoundError``.  ``manifest``: a TSV of
    ``url<TAB>caption`` lines, the caption naming the image."""

    def __init__(self, manifest: str, image_dir: str, preprocessed_dir: str,
                 resolution: int = 256, seed: int = 0):
        self.urls = {}
        with open(manifest) as f:
            for line in f:
                url, caption = line.split("\t", 1)
                self.urls[caption.strip()] = url
        os.makedirs(image_dir, exist_ok=True)
        super().__init__(image_dir, preprocessed_dir, resolution, seed)

    def _fetch(self, name: str) -> bool:
        from urllib.request import urlretrieve

        try:
            urlretrieve(self.urls[name],
                        os.path.join(self.image_dir, name + ".jpg"))
            return True
        except Exception as exn:                       # noqa: BLE001
            print("Failed to download the image:", name, exn)
            return False

    def __getitem__(self, idx: int):
        name = self.names[idx]
        path = os.path.join(self.image_dir, name + ".jpg")
        if not os.path.exists(path) and name in self.urls:
            self._fetch(name)
        return super().__getitem__(idx)


class ConcatDataset:
    """Map-style datasets joined end to end."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.cumulative = list(itertools.accumulate(
            len(d) for d in self.datasets))

    def __len__(self) -> int:
        return self.cumulative[-1] if self.cumulative else 0

    def get_true_idx(self, idx: int):
        """(dataset index, index within it) of ``idx`` (negative counts
        from the end)."""
        import bisect

        if idx < 0:
            if -idx > len(self):
                raise ValueError("index out of range")
            idx += len(self)
        di = bisect.bisect_right(self.cumulative, idx)
        si = idx if di == 0 else idx - self.cumulative[di - 1]
        return di, si

    def __getitem__(self, idx: int):
        di, si = self.get_true_idx(idx)
        return self.datasets[di][si]


# --- collate and batching -------------------------------------------------

def collate(samples: Sequence[Dict[str, object]], max_boxes: int = 6,
            need_seg: bool = True) -> Dict[str, object]:
    """Samples -> ``image`` [B, H, W, 3], ``bbox_obj`` / ``bbox_face``
    [B, max_boxes, 4] (zero rows padding), ``caption`` list and, when
    ``need_seg``, ``mask`` [B, H, W, 159]."""
    batch: Dict[str, object] = {
        "image": np.stack([s["image"] for s in samples]).astype(np.float32),
        "bbox_obj": np.stack([pad_boxes(s.get("box_things", []), max_boxes)
                              for s in samples]),
        "bbox_face": np.stack([pad_boxes(s.get("box_face", []), max_boxes)
                               for s in samples]),
        "caption": [s.get("caption", "") for s in samples],
    }
    if need_seg:
        batch["mask"] = np.stack(
            [s["mask"] for s in samples]).astype(np.float32)
    return batch


def batch_iterator(dataset: Iterable[Dict[str, object]], batch_size: int,
                   max_boxes: int = 6, need_seg: bool = True,
                   drop_last: bool = True) -> Iterator[Dict[str, object]]:
    """``collate`` of each ``batch_size`` samples of ``dataset``; a last
    short batch is dropped unless ``drop_last`` is False."""
    buf: List[Dict[str, object]] = []
    for sample in dataset:
        buf.append(sample)
        if len(buf) == batch_size:
            yield collate(buf, max_boxes, need_seg)
            buf = []
    if buf and not drop_last:
        yield collate(buf, max_boxes, need_seg)


# --- synthetic batches ------------------------------------------------------


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
