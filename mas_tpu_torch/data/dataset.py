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
  * ``Synthetic*Batches`` are seeded random batches of each stage;
    ``StructuredSceneBatches`` are seeded learnable scenes (aligned RGB,
    seg map and boxes), optionally from a scene pool kept in memory or
    saved to disk.

Batches are dicts of numpy arrays, NHWC, images float32 in [0, 1] (or
uint8, and packed int16 seg labels, where a dataset is asked to).  The
same files, or numpy draws from the same seed, give the same batches as
the JAX package.
"""

from __future__ import annotations

import io
import itertools
import os
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from .segmap import (NUM_SEG_CHANNELS, assemble_seg_map,
                     assemble_seg_map_into, edges_from_instances,
                     pack_seg_labels, pad_boxes, sanitize_bboxes)
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


# The version is part of a saved pool's directory name, so a pool of an
# older ``StructuredSceneBatches._scene`` or layout is never reused; it
# equals the JAX package's, so pools interchange between the packages.
_POOL_FORMAT_VERSION = 2

# Per-scene fields saved as stacked .npy arrays, in scene-tuple order.  The
# object and face boxes (fields 5 and 6) vary in length and are saved as
# one concatenated [sum_k, 4] array each plus an int64 offset vector.
_POOL_FIELDS = ("img", "pan", "hum", "face", "edge")


class _ScenePoolView:
    """Random access over a saved scene-pool directory, memory-mapped:
    ``pool[i]`` is the 7-tuple of the in-memory pool, read lazily through
    the page cache."""

    def __init__(self, path: str):
        self._fields = [
            np.load(os.path.join(path, name + ".npy"), mmap_mode="r")
            for name in _POOL_FIELDS]
        self._box = np.load(os.path.join(path, "box.npy"), mmap_mode="r")
        self._box_off = np.load(os.path.join(path, "box_off.npy"))
        self._fbox = np.load(os.path.join(path, "fbox.npy"), mmap_mode="r")
        self._fbox_off = np.load(os.path.join(path, "fbox_off.npy"))
        n = len(self._fields[0])
        if any(len(f) != n for f in self._fields) or \
                len(self._box_off) != n + 1 or len(self._fbox_off) != n + 1:
            raise ValueError("scene-pool field lengths disagree")

    def __len__(self) -> int:
        return len(self._fields[0])

    def __getitem__(self, i):
        o, fo = self._box_off, self._fbox_off
        return tuple(f[i] for f in self._fields) + (
            np.asarray(self._box[o[i]:o[i + 1]]),
            np.asarray(self._fbox[fo[i]:fo[i + 1]]))


class StructuredSceneBatches:
    """Learnable synthetic scenes: aligned RGB, the 159-channel seg map and
    boxes, as ``mas_tpu/data/dataset.py``'s, bit for bit for one seed.

    A scene is a two-band stuff background (sky over ground at a random
    horizon), 2-5 shaded elliptical "thing" instances of random panoptic
    classes, and one person carrying three human-parts bands and a 5-class
    face.  The RGB renders the same geometry (a vertical gradient, a color
    per instance with radial shading, a little noise), so image and seg
    map agree and every stage can learn from them, unlike the iid noise of
    ``Synthetic*Batches``.

    ``compact``: yield ``seg_packed`` int16 [B, r, r, 4] labels
    (``segmap.pack_seg_labels``) in place of the dense fp32 ``mask``; the
    seg step expands them on the device (``one_hot_seg_packed``).
    ``image_u8``: yield ``image`` as uint8 in [0, 255], truncated, in place
    of float32 in [0, 1]; the steps convert on the device
    (``train.steps.to_float_image``).

    ``cache_scenes`` > 0: draw that many scenes once (compact dtypes) and
    cycle through them in a fresh shuffled order each pass, writing each
    batch into one of 8 rotating preallocated buffers: a yielded batch is
    overwritten 8 batches later, so a caller that keeps one copies it.
    Scenes left over after the last whole batch of a pass make no batch.
    ``workers`` is stored and not read, as in the JAX package; no thread
    is started.

    ``pool_cache_dir``: save the drawn pool there, keyed by (format
    version, resolution, cache_scenes, seed, max_boxes), as a directory of
    plain .npy files (never pickle), and memory-map it on a later run
    instead of drawing it again.  Loading skips the generator's scene
    draws, so the shuffle order then differs from a run that drew the
    pool: the same scenes in another order.
    """

    #: COCO-panoptic-style ids: things < 80, stuff >= 80 (sky, ground)
    SKY, GROUND = 119, 125
    PERSON = 0

    def __init__(self, batch_size: int, resolution: int = 256, seed: int = 0,
                 max_boxes: int = 6, cache_scenes: int = 0,
                 workers: int = 4, compact: bool = False,
                 image_u8: bool = False,
                 pool_cache_dir: Optional[str] = None):
        self.batch_size = batch_size
        self.resolution = resolution
        self.max_boxes = max_boxes
        self.rng = np.random.default_rng(seed)
        if 0 < cache_scenes < batch_size:
            raise ValueError(
                f"cache_scenes ({cache_scenes}) must be >= batch_size "
                f"({batch_size}): one batch draws that many distinct "
                f"pool scenes")
        self.cache_scenes = cache_scenes
        self.workers = workers
        self.compact = compact
        self.image_u8 = image_u8
        self.pool_cache_dir = pool_cache_dir
        self.pool_seed = seed

    def _ellipse(self, xx, yy, cx, cy, a, b):
        return ((xx - cx) / a) ** 2 + ((yy - cy) / b) ** 2 <= 1.0

    def _scene(self):
        # Statement for statement the JAX package's: the order of the
        # draws and every dtype decide the bits and the saved pools.
        rng, r = self.rng, self.resolution
        yy, xx = np.mgrid[0:r, 0:r].astype(np.float32)

        horizon = int(rng.integers(r // 4, 3 * r // 4))
        pan = np.where(yy < horizon, self.SKY, self.GROUND).astype(np.int64)
        inst = np.where(yy < horizon, 0, 1).astype(np.int64)
        hum = np.full((r, r), -1, np.int64)
        face = np.zeros((r, r), np.int64)

        c_sky = rng.random(3) * 0.5 + 0.5
        c_gnd = rng.random(3) * 0.5
        t = (yy / r)[..., None]
        img = (1 - t) * c_sky + t * c_gnd          # vertical gradient
        img = img.astype(np.float32)

        boxes, next_inst = [], 2

        def paint(m, color, cx, cy, a, b):
            shade = 1.0 - 0.45 * (((xx - cx) / a) ** 2
                                  + ((yy - cy) / b) ** 2)
            img[m] = (color[None, None, :] * shade[..., None])[m]
            ys, xs = np.nonzero(m)
            boxes.append([xs.min(), ys.min(), xs.max(), ys.max()])

        for _ in range(int(rng.integers(2, 6))):
            a, b = rng.integers(r // 10, r // 4, 2)
            cx = rng.integers(a, r - a)
            cy = rng.integers(b, r - b)
            m = self._ellipse(xx, yy, cx, cy, a, b)
            pan[m] = int(rng.integers(1, 80))       # thing class (not person)
            inst[m] = next_inst
            next_inst += 1
            paint(m, rng.random(3), cx, cy, a, b)

        # person: body ellipse with 3 part bands + a small 5-class face
        a, b = r // 8, r // 3
        cx = int(rng.integers(a, r - a))
        cy = int(rng.integers(b, r - b))
        body = self._ellipse(xx, yy, cx, cy, a, b)
        pan[body] = self.PERSON
        inst[body] = next_inst
        paint(body, rng.random(3) * 0.6 + 0.3, cx, cy, a, b)
        rel = (yy - (cy - b)) / (2 * b)             # 0 head .. 1 feet
        for lo, hi, part in ((0.0, 0.25, 13), (0.25, 0.6, 5),
                             (0.6, 1.01, 9)):       # face/torso/legs (LIP)
            hum[body & (rel >= lo) & (rel < hi)] = part
        fa, fb = max(a // 2, 4), max(b // 6, 4)
        fcy = cy - b + fb + 1
        fmask = self._ellipse(xx, yy, cx, fcy, fa, fb)
        frel = (yy - (fcy - fb)) / (2 * fb)
        for lo, hi, cls in ((0.1, 0.3, 2), (0.3, 0.5, 4), (0.45, 0.7, 3),
                            (0.7, 0.85, 5), (0.85, 1.0, 1)):
            face[fmask & (frel >= lo) & (frel < hi)] = cls   # brow .. beard
        if fmask.any():
            ys, xs = np.nonzero(fmask)
            face_boxes = [[xs.min(), ys.min(), xs.max(), ys.max()]]
        else:
            face_boxes = []

        edge = edges_from_instances(inst)
        img += rng.normal(0.0, 0.01, img.shape).astype(np.float32)
        return (np.clip(img, 0.0, 1.0), pan, hum, face, edge,
                boxes, face_boxes)

    def _pack(self, scene):
        """A scene -> one batch row (image, mask or packed labels, object
        boxes, face boxes)."""
        img, pan, hum, face, edge, boxes, face_boxes = scene
        if self.compact:
            mask = pack_seg_labels(pan, edge, hum, face)
        else:
            mask = assemble_seg_map(pan, edge, hum, np.zeros_like(edge),
                                    face)
        m, r = self.max_boxes, self.resolution
        if self.image_u8:
            img = (np.asarray(img) * 255).astype(np.uint8)
        else:
            img = np.asarray(img, np.float32)
        return (img, mask,
                pad_boxes(sanitize_bboxes(boxes, frame=r), m),
                pad_boxes(sanitize_bboxes(face_boxes, frame=r), m))

    @property
    def _mask_key(self):
        return "seg_packed" if self.compact else "mask"

    def _batch(self, rows):
        imgs, masks, bo, bf = zip(*rows)
        return {"image": np.stack(imgs), self._mask_key: np.stack(masks),
                "bbox_obj": np.stack(bo), "bbox_face": np.stack(bf)}

    def _pool_path(self) -> Optional[str]:
        if not self.pool_cache_dir:
            return None
        return os.path.join(
            self.pool_cache_dir,
            f"scenes_v{_POOL_FORMAT_VERSION}_r{self.resolution}"
            f"_n{self.cache_scenes}_s{self.pool_seed}_m{self.max_boxes}")

    def _load_pool(self):
        path = self._pool_path()
        if path is None or not os.path.isdir(path):
            return None
        try:
            return _ScenePoolView(path)
        except (OSError, ValueError) as exn:
            print(f"scene-pool cache at {path} unreadable ({exn}); "
                  "regenerating", flush=True)
            return None

    def _save_pool(self, scenes) -> None:
        path = self._pool_path()
        if path is None:
            return
        from numpy.lib.format import open_memmap

        os.makedirs(self.pool_cache_dir, exist_ok=True)
        tmp = path + ".tmp"     # renamed when whole: a killed run leaves
        os.makedirs(tmp, exist_ok=True)     # no readable partial pool
        n = len(scenes)
        for j, name in enumerate(_POOL_FIELDS):
            first = np.asarray(scenes[0][j])
            mm = open_memmap(os.path.join(tmp, name + ".npy"), mode="w+",
                             dtype=first.dtype, shape=(n,) + first.shape)
            for i in range(n):
                mm[i] = scenes[i][j]
            mm.flush()
            del mm
        for j, name in ((5, "box"), (6, "fbox")):
            parts = [np.asarray(sc[j], np.float32).reshape(-1, 4)
                     for sc in scenes]
            off = np.zeros(n + 1, np.int64)
            off[1:] = np.cumsum([len(p) for p in parts])
            cat = (np.concatenate(parts) if parts
                   else np.zeros((0, 4), np.float32))
            np.save(os.path.join(tmp, name + ".npy"), cat)
            np.save(os.path.join(tmp, name + "_off.npy"), off)
        try:
            os.replace(tmp, path)
        except OSError:
            # another process saved the same pool first; keep theirs
            import shutil
            shutil.rmtree(tmp, ignore_errors=True)

    def __iter__(self):
        if not self.cache_scenes:
            while True:
                yield self._batch([self._pack(self._scene())
                                   for _ in range(self.batch_size)])

        scenes = self._load_pool()
        if scenes is None:
            scenes = []
            for _ in range(self.cache_scenes):
                img, pan, hum, face, edge, bx, fbx = self._scene()
                scenes.append(((img * 255).astype(np.uint8),
                               pan.astype(np.int16), hum.astype(np.int8),
                               face.astype(np.int8), edge.astype(np.uint8),
                               bx, fbx))
            self._save_pool(scenes)

        # 8 rotating preallocated batch buffers (warm pages, no allocation
        # a batch), more than any prefetch downstream holds at once
        b, r, m = self.batch_size, self.resolution, self.max_boxes
        mask_shape = ((b, r, r, 4) if self.compact
                      else (b, r, r, NUM_SEG_CHANNELS))
        mask_dtype = np.int16 if self.compact else np.float32
        img_dtype = np.uint8 if self.image_u8 else np.float32
        pool = [{"image": np.zeros((b, r, r, 3), img_dtype),
                 self._mask_key: np.zeros(mask_shape, mask_dtype),
                 "bbox_obj": np.zeros((b, m, 4), np.float32),
                 "bbox_face": np.zeros((b, m, 4), np.float32)}
                for _ in range(8)]
        prev_scatter = [[None] * b for _ in pool]
        slot = 0
        while True:
            order = self.rng.permutation(self.cache_scenes)
            for start in range(0, self.cache_scenes - b + 1, b):
                buf = pool[slot]
                prev = prev_scatter[slot]
                slot = (slot + 1) % len(pool)
                for row, i in enumerate(order[start:start + b]):
                    img, pan, hum, face, edge, bx, fbx = scenes[i]
                    if self.image_u8:
                        buf["image"][row] = img      # stored uint8 already
                    else:
                        np.multiply(img, np.float32(1.0 / 255.0),
                                    out=buf["image"][row])
                    if self.compact:
                        pk = buf["seg_packed"][row]
                        pk[..., 0] = pan
                        pk[..., 1] = hum
                        pk[..., 2] = face
                        pk[..., 3] = edge
                    else:
                        # clear only the ones this buffer's row last set
                        prev[row] = assemble_seg_map_into(
                            buf["mask"][row], pan, edge, hum,
                            np.zeros_like(edge), face, prev=prev[row])
                    buf["bbox_obj"][row] = pad_boxes(
                        sanitize_bboxes(bx, frame=r), m)
                    buf["bbox_face"][row] = pad_boxes(
                        sanitize_bboxes(fbx, frame=r), m)
                yield buf
