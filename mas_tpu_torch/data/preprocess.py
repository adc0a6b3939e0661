"""Offline data factory, as ``mas_tpu/data/preprocess.py``: run the three
annotators (panoptic, human parts, face) over an image corpus and write
their outputs, either as per-image npz files (local mode) or repacked
with each image and caption into processed tar shards that
``PreprocessedWebDataset`` reads (web mode).

An annotator is any callable image [H, W, 3] float in [0, 1] -> dict of
arrays.  ``SyntheticAnnotator`` stands in for the networks with seeded
random instances around the real geometry of ``annotate.py``;
``TorchScriptAnnotator`` runs a user's serialized module on a torch
device.  No annotator network is part of the repository.

  * local mode: one process per (annotator, worker); each takes every
    ``total``-th image and saves ``{name}_{kind}.npz``,
  * web mode: one process per annotator over the shards, a coordinator
    that counts per-shard completions through a ready queue of
    ``{kind}/{worker}/{event}/{shard}`` messages and repacks a shard (in
    a process of its own) once every annotator reports it done, a
    run-ahead throttle (``max_ahead``) that bounds the scratch npz files,
    a liveness check on the annotator processes, ``info.state`` progress
    and machine-level sharding (``machine_idx`` / ``machines_total``).

Worker processes start with the platform's default method (fork on
Linux), unless an annotator runs on a CUDA device: a forked child cannot
use CUDA once its parent has, so those runs start every worker by spawn.
"""

from __future__ import annotations

import io
import json
import multiprocessing as mp
import os
import tarfile
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .tario import expand_shards, iter_tar_samples

Annotator = Callable[[np.ndarray], Dict[str, np.ndarray]]

ANNOTATOR_KINDS = ("panoptic", "human", "face")


class SyntheticAnnotator:
    """Deterministic stand-in for an annotator network: random instance
    rectangles, part logits or landmark sets, seeded by ``seed`` and the
    image, through the real geometry (``panoptic_thing_boxes``,
    ``edges_from_instances``, ``human_logits_to_mask``,
    ``faces_to_mask``, ``masks_to_boxes``)."""

    def __init__(self, kind: str, seed: int = 0):
        assert kind in ANNOTATOR_KINDS
        self.kind = kind
        self.seed = seed

    def __call__(self, image: np.ndarray) -> Dict[str, np.ndarray]:
        from .annotate import faces_to_mask, masks_to_boxes, \
            panoptic_thing_boxes
        from .segmap import edges_from_instances

        h, w = image.shape[:2]
        rng = np.random.default_rng(
            self.seed + int(image[:8, :8].sum() * 255) % 100003)
        if self.kind == "panoptic":
            # 1000 * class + instance rectangles on a "stuff" background
            pan = np.full((h, w), 100 * 1000, np.int64)
            for inst in range(1, int(rng.integers(2, 5))):
                cls = int(rng.integers(0, 133))
                y, x = rng.integers(0, max(h - 8, 1)), rng.integers(
                    0, max(w - 8, 1))
                bh, bw = rng.integers(6, h // 2 + 7), rng.integers(
                    6, w // 2 + 7)
                pan[y:y + bh, x:x + bw] = cls * 1000 + inst
            return {
                "seg_panoptic": (pan // 1000).astype(np.int16),
                "edges": edges_from_instances(pan).astype(np.uint8),
                "box_things": panoptic_thing_boxes(pan),
            }
        if self.kind == "human":
            # logits at the parsing net's output size (473 / 4 + 1); the
            # logits -> mask half of the transform chain is the real one
            from .annotate import (HUMAN_PARTS_CLASSES,
                                   HUMAN_PARTS_INPUT_SIZE,
                                   human_logits_to_mask)

            out_hw = HUMAN_PARTS_INPUT_SIZE[0] // 4 + 1
            logits = np.full((1, HUMAN_PARTS_CLASSES, out_hw, out_hw),
                             -4.0, np.float32)
            logits[:, 0] = 4.0                               # background
            for part in range(int(rng.integers(1, 4))):
                y, x = rng.integers(0, out_hw - 2), rng.integers(
                    0, out_hw - 2)
                bh, bw = rng.integers(2, out_hw // 2), rng.integers(
                    2, out_hw // 2)
                cls = int(rng.integers(1, HUMAN_PARTS_CLASSES))
                logits[0, cls, y:y + bh, x:x + bw] = 8.0
            parts = human_logits_to_mask(logits, h, w)[0].astype(np.int16)
            return {
                "seg_human": parts,
                "edges": edges_from_instances(parts).astype(np.uint8),
            }
        # face: random landmark sets -> contour rasterization
        n_faces = int(rng.integers(0, 3))
        landmarks = (rng.random((n_faces, 68, 2))
                     * np.array([w - 2, h - 2]) + 1)
        seg_face = faces_to_mask((h, w), landmarks) if n_faces else np.zeros(
            (h, w), np.uint8)
        boxes = (masks_to_boxes(
            np.stack([faces_to_mask((h, w), lm[None]) for lm in landmarks]))
            if n_faces else np.zeros((0, 4), np.float32))
        return {"seg_face": seg_face, "box_face": boxes}


class TorchScriptAnnotator:
    """A user's ``torch.jit`` module that maps [1, 3, H, W] float images
    to a dict of the npz schema's tensors, loaded on first call (inside
    the worker process) onto ``device`` and run there."""

    def __init__(self, kind: str, path: str, device="cuda"):
        self.kind = kind
        self.path = path
        self.device = str(device)
        self._model = None

    def __call__(self, image: np.ndarray) -> Dict[str, np.ndarray]:
        import torch

        if self._model is None:
            self._model = torch.jit.load(self.path,
                                         map_location=self.device)
        with torch.no_grad():
            out = self._model(torch.from_numpy(image).permute(2, 0, 1)[None]
                              .float().to(self.device))
        return {k: v.cpu().numpy() for k, v in out.items()}


def _context(annotators: Dict[str, Annotator]):
    """The multiprocessing context of a run: spawn when an annotator runs
    on a CUDA device, else the platform's default."""
    on_cuda = any(str(getattr(a, "device", "cpu")).startswith("cuda")
                  for a in annotators.values())
    return mp.get_context("spawn" if on_cuda else None)


# --- local mode -------------------------------------------------------------

def preprocess_local(image_paths: Sequence[str], out_dir: str,
                     annotators: Dict[str, Annotator],
                     workers_per_annotator: int = 1) -> None:
    """One process per (annotator, worker); each strides over the images
    and writes ``{name}_{kind}.npz`` where it is not there yet."""
    os.makedirs(out_dir, exist_ok=True)
    ctx = _context(annotators)
    procs = []
    for kind, ann in annotators.items():
        for w in range(workers_per_annotator):
            p = ctx.Process(target=_local_worker,
                            args=(list(image_paths), out_dir, kind, ann, w,
                                  workers_per_annotator))
            p.start()
            procs.append(p)
    for p in procs:
        p.join()
        if p.exitcode != 0:
            raise RuntimeError(f"annotator worker failed: {p.exitcode}")


def _local_worker(paths: List[str], out_dir: str, kind: str, ann: Annotator,
                  worker: int, total: int) -> None:
    from .dataset import decode_jpg

    for i, path in enumerate(paths):
        if i % total != worker:
            continue
        name = os.path.splitext(os.path.basename(path))[0]
        dst = os.path.join(out_dir, f"{name}_{kind}.npz")
        if os.path.exists(dst):
            continue
        with open(path, "rb") as f:
            img = decode_jpg(f.read())
        np.savez(dst, **ann(img))


# --- web (tar shard) mode ---------------------------------------------------

def preprocess_web(shards, out_dir: str, annotators: Dict[str, Annotator],
                   machine_idx: int = 0, machines_total: int = 1,
                   max_repack: int = 4, max_ahead: int = 4,
                   out_url: Optional[str] = None) -> List[str]:
    """Annotate every sample of every shard of this machine, then repack
    processed shards; returns the output tar paths (or URLs).

    ``max_ahead`` bounds how many shards a fast annotator may run ahead of
    the slowest (the scratch npz files of shards not yet repacked);
    ``max_repack`` bounds the repack processes at once.  ``out_url``: a
    sink template with ``{name}`` (the shard's basename), e.g. ``pipe:aws
    s3 cp - s3://bucket/{name}``; without it tars land in ``out_dir``.  A
    failed annotator or repack process fails the run, once every process
    has been joined (``mas_tpu`` checks only the repack processes' exit
    codes, and returns as if an annotator that raised had finished).
    """
    os.makedirs(out_dir, exist_ok=True)
    scratch = os.path.join(out_dir, "_scratch")
    os.makedirs(scratch, exist_ok=True)
    shards = [s for i, s in enumerate(expand_shards(shards))
              if i % machines_total == machine_idx]

    ctx = _context(annotators)
    ready = ctx.Queue()
    # per-kind completed-shard counters, shared for the run-ahead throttle
    done_counters = ctx.Array("i", len(annotators))
    procs = []
    for idx, (kind, ann) in enumerate(annotators.items()):
        p = ctx.Process(target=_web_worker,
                        args=(shards, scratch, kind, ann, ready,
                              done_counters, idx, max_ahead))
        p.start()
        procs.append(p)

    done_counts: Dict[str, int] = {}
    state: Dict[str, str] = {}
    outputs: List[str] = []
    n_kinds = len(annotators)
    finished_workers = 0
    repack_procs: List = []
    all_repack: List[Tuple[object, str]] = []    # for the exit codes

    def handle(msg: str) -> None:
        nonlocal finished_workers, repack_procs
        kind, worker, event, tar = msg.split("/", 3)
        if event == "exit":
            finished_workers += 1
            return
        if event != "done":
            state[tar] = f"{kind}:{event}"
            return
        done_counts[tar] = done_counts.get(tar, 0) + 1
        if done_counts[tar] == n_kinds:
            name = os.path.basename(tar)
            out_tar = (out_url.format(name=name) if out_url
                       else os.path.join(out_dir, name))
            repack_procs = [p for p in repack_procs if p.is_alive()]
            while len(repack_procs) >= max_repack:
                time.sleep(0.05)
                repack_procs = [p for p in repack_procs if p.is_alive()]
            p = ctx.Process(target=repack_single_tar,
                            args=(tar, scratch, out_tar, tuple(annotators)))
            p.start()
            repack_procs.append(p)
            all_repack.append((p, out_tar))
            outputs.append(out_tar)
            _write_state(out_dir, done_counts, state)

    while finished_workers < n_kinds:
        try:
            msg = ready.get(timeout=5.0)
        except Exception:                              # queue.Empty
            # a worker killed without its exit message would block the
            # loop forever
            dead = [p for p in procs if not p.is_alive()
                    and p.exitcode not in (0, None)]
            if dead:
                for p in procs + repack_procs:
                    p.terminate()
                raise RuntimeError(
                    f"annotator worker(s) died: "
                    f"{[p.exitcode for p in dead]}") from None
            if all(not p.is_alive() for p in procs):
                # every worker exited cleanly, but its last messages may
                # still be in the queue's feeder threads: drain them, or
                # the last shard is never repacked
                while True:
                    try:
                        handle(ready.get(timeout=0.5))
                    except Exception:                  # queue.Empty
                        break
                break
            continue
        handle(msg)
    for p in procs + repack_procs:
        p.join()
    # an annotator that raised still sent its exit message; its shards
    # were never repacked
    failed = [p.exitcode for p in procs if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"annotator worker(s) failed: {failed}")
    # a failed sink (or any error in repack_single_tar) exits the child
    # nonzero; without this the shard would count as written
    failed = [(out, p.exitcode) for p, out in all_repack
              if p.exitcode not in (0, None)]
    if failed:
        raise RuntimeError(f"repack process(es) failed: {failed}")
    return outputs


def _scratch_name(shard: str, key: str, kind: str) -> str:
    """Scratch npz name, namespaced by shard so that equal sample keys in
    two shards never collide."""
    base = os.path.splitext(os.path.basename(shard))[0]
    return f"{base}__{key}_{kind}.npz"


def _web_worker(shards: List[str], scratch: str, kind: str, ann: Annotator,
                ready, done_counters, idx: int, max_ahead: int) -> None:
    from .dataset import decode_jpg

    try:
        for shard in shards:
            # run-ahead throttle: wait until the slowest annotator is
            # within max_ahead shards
            while True:
                with done_counters.get_lock():
                    lag = done_counters[idx] - min(done_counters)
                if lag < max_ahead:
                    break
                time.sleep(0.05)
            ready.put(f"{kind}/0/started/{shard}")
            for sample in iter_tar_samples(shard):
                if "jpg" not in sample:
                    continue
                img = decode_jpg(sample["jpg"])  # type: ignore[arg-type]
                key = sample["__key__"]
                np.savez(os.path.join(
                    scratch, _scratch_name(shard, key, kind)), **ann(img))
            with done_counters.get_lock():
                done_counters[idx] += 1
            ready.put(f"{kind}/0/done/{shard}")
    finally:
        # the exit message goes out even after an exception, so the
        # coordinator never waits on the queue forever
        ready.put(f"{kind}/0/exit/-")


def _open_tar_sink(out_tar: str):
    """Writable tar on a local path, or streamed into the standard input
    of a ``pipe:<cmd>`` URL -> (tar, subprocess or None)."""
    import subprocess

    if out_tar.startswith("pipe:"):
        proc = subprocess.Popen(out_tar[5:], shell=True,
                                stdin=subprocess.PIPE, bufsize=1 << 20)
        assert proc.stdin is not None
        return tarfile.open(fileobj=proc.stdin, mode="w|"), proc
    return tarfile.open(out_tar, "w"), None


def repack_single_tar(src_tar: str, scratch: str, out_tar: str,
                      kinds: Sequence[str]) -> None:
    """Source ``jpg`` / ``txt`` members + the per-kind npz outputs -> one
    processed tar with one combined npz per sample; samples missing a
    kind's output are left out.  ``out_tar``: a path or a ``pipe:`` URL,
    whose command's failure raises."""
    out, proc = _open_tar_sink(out_tar)
    try:
        try:
            _repack_into(out, src_tar, scratch, kinds)
            out.close()
        except BrokenPipeError:
            pass        # the sink command died: its exit code says so
    finally:
        if proc is not None:
            try:
                proc.stdin.close()
            except BrokenPipeError:
                pass
            rc = proc.wait()
            if rc != 0:
                raise RuntimeError(
                    f"repack sink command failed (rc={rc}): {out_tar}")


def _repack_into(out: tarfile.TarFile, src_tar: str, scratch: str,
                 kinds: Sequence[str]) -> None:
    for sample in iter_tar_samples(src_tar):
        key = sample["__key__"]
        merged: Dict[str, np.ndarray] = {}
        ok = True
        for kind in kinds:
            path = os.path.join(scratch,
                                _scratch_name(src_tar, key, kind))
            if not os.path.exists(path):
                ok = False
                break
            with np.load(path) as z:
                for name in z.files:
                    merged[_RENAME.get((kind, name), name)] = z[name]
        if not ok:
            continue
        for ext in ("jpg", "txt"):
            if ext in sample:
                _add_member(out, f"{key}.{ext}", sample[ext])
        buf = io.BytesIO()
        np.savez(buf, **merged)
        _add_member(out, f"{key}.npz", buf.getvalue())


# annotator npz names -> combined npz names (each annotator writes
# "edges"; the processed shards keep edge_panoptic and edge_human)
_RENAME = {
    ("panoptic", "edges"): "edge_panoptic",
    ("human", "edges"): "edge_human",
}


def _add_member(tf: tarfile.TarFile, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def _write_state(out_dir: str, done_counts: Dict[str, int],
                 state: Dict[str, str]) -> None:
    """Progress JSON: completions per shard and each shard's last
    event."""
    with open(os.path.join(out_dir, "info.state"), "w") as f:
        json.dump({"done": done_counts, "state": state}, f)


def run_preprocessor(cfg: Dict, device="cuda") -> List[str]:
    """The ``preprocess`` section of a config -> the annotators (type
    ``synthetic`` with an optional ``seed``, or ``torchscript`` with a
    ``path``, run on ``device``), then local mode (``images``,
    ``out_dir``, ``workers_per_annotator``; returns []) or web mode
    (``shards``, ``out_dir``, ``machine_idx``, ``machines_total``,
    ``out_url``; returns the written shards)."""
    anns: Dict[str, Annotator] = {}
    for kind in ANNOTATOR_KINDS:
        spec = cfg.get("annotators", {}).get(kind, {"type": "synthetic"})
        if spec.get("type") == "torchscript":
            anns[kind] = TorchScriptAnnotator(kind, spec["path"], device)
        else:
            anns[kind] = SyntheticAnnotator(kind, seed=spec.get("seed", 0))
    if cfg.get("mode", "web") == "local":
        preprocess_local(cfg["images"], cfg["out_dir"], anns,
                         cfg.get("workers_per_annotator", 1))
        return []
    return preprocess_web(cfg["shards"], cfg["out_dir"], anns,
                          machine_idx=cfg.get("machine_idx", 0),
                          machines_total=cfg.get("machines_total", 1),
                          out_url=cfg.get("out_url"))
