"""The port's data layer vs the JAX package's, on CPU: tar shards
(grouping, ``pipe:`` URLs and reaping, ``shard_split``,
``expand_shards``), ``parallel_map`` and ``prefetch``, the seg-map and
annotator geometry, the datasets, ``collate`` / ``batch_iterator`` and the
CLI's ``data_iter`` for ``webdataset`` and ``local_npz``.

Inputs are files and arrays made from a numpy seed; both packages read
the same files.  Every numpy path must agree bitwise; ``one_hot_seg``
(torch against jnp) too.
"""

import importlib
import io
import os
import tarfile
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mas_tpu.data import annotate as jannotate
from mas_tpu.data import dataset as jdataset
from mas_tpu.data import segmap as jsegmap
from mas_tpu.data import tario as jtario

from mas_tpu_torch.data import annotate, dataset, segmap, tario
from mas_tpu_torch.utils.config import VQModelConfig

# the modules (each package's data/__init__.py exports the function
# ``prefetch`` under the module's name)
prefetch = importlib.import_module("mas_tpu_torch.data.prefetch")
jprefetch = importlib.import_module("mas_tpu.data.prefetch")

# source sizes (h, w): landscape, portrait, square, and one at the target
SIZES = ((48, 64), (72, 48), (40, 40), (32, 32))


def _jpeg(rng, h, w) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(
        buf, "JPEG")
    return buf.getvalue()


def _npz(rng, h, w) -> bytes:
    buf = io.BytesIO()
    np.savez(buf,
             seg_panoptic=rng.integers(-1, 133, (h, w)).astype(np.int16),
             edge_panoptic=rng.integers(0, 2, (h, w)).astype(np.uint8),
             seg_human=rng.integers(-1, 20, (h, w)).astype(np.int16),
             edge_human=rng.integers(0, 2, (h, w)).astype(np.uint8),
             seg_face=rng.integers(0, 6, (h, w)).astype(np.uint8),
             box_things=rng.uniform(-8, 80, (3, 4)).astype(np.float32),
             box_face=rng.uniform(0, 60, (int(rng.integers(0, 3)), 4))
             .astype(np.float32))
    return buf.getvalue()


def add_member(tf, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def write_processed_shard(path, n, seed, broken=()):
    """A processed shard of ``n`` samples of SIZES in turn; sample indices
    in ``broken`` get a JPEG that does not decode, and sample 1 has no
    npz (both are skipped by the datasets)."""
    rng = np.random.default_rng(seed)
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            h, w = SIZES[i % len(SIZES)]
            key = f"s{seed}_{i:04d}"
            add_member(tf, f"{key}.jpg",
                       b"not a jpeg" if i in broken else _jpeg(rng, h, w))
            if i != 1:
                add_member(tf, f"{key}.npz", _npz(rng, h, w))
            add_member(tf, f"{key}.txt", f"caption {seed} {i}".encode())
    return path


def shards(tmp_path, n=6):
    d = tmp_path / "shards"
    d.mkdir(exist_ok=True)
    return [write_processed_shard(str(d / f"{k:03d}.tar"), n, k,
                                  broken=(4,) if k == 1 else ())
            for k in range(2)]


def assert_same(a, b):
    """Equal nested dicts / lists / arrays, bitwise, of the same dtype."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)


# --- tar shards -------------------------------------------------------------

def test_tar_samples_match_jax(tmp_path):
    """Members grouped by key (dirs skipped, nested names, no extension,
    a key that comes back later is a new sample), local and pipe: URLs."""
    path = str(tmp_path / "x.tar")
    with tarfile.open(path, "w") as tf:
        info = tarfile.TarInfo("dir")
        info.type = tarfile.DIRTYPE
        tf.addfile(info)
        for name in ("dir/a.jpg", "dir/a.seg.npz", "a.txt", "b", "b.txt",
                     "a.cls"):
            add_member(tf, name, name.encode() * 3)
    for url in (path, f"pipe:cat {path}"):
        got, want = list(tario.iter_tar_samples(url)), \
            list(jtario.iter_tar_samples(url))
        assert [s["__key__"] for s in got] == ["a", "b", "a"]
        assert_same(got, want)


def _zombies():
    """PIDs of this process's unreaped children."""
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == os.getpid() and fields[0] == "Z":
            out.append(int(pid))
    return set(out)


@pytest.mark.parametrize("early_close", [False, True])
def test_pipe_shard_subprocess_is_reaped(tmp_path, early_close):
    """A drained pipe: shard reaps its command; an early close terminates
    a command that runs on, and reaps it, without waiting for it."""
    path = write_processed_shard(str(tmp_path / "x.tar"), 3, 0)
    before = _zombies()
    it = tario.iter_tar_samples(f"pipe:cat {path}; sleep 60"
                                if early_close else f"pipe:cat {path}")
    t0 = time.monotonic()
    if early_close:
        next(it)
        it.close()
    else:
        assert len(list(it)) == 3
    assert time.monotonic() - t0 < 30
    assert _zombies() <= before


@pytest.mark.parametrize("n,index,count,worker,workers", [
    (13, 0, 1, 0, 1), (13, 1, 2, 0, 1), (13, 1, 2, 2, 3), (2, 3, 4, 0, 1)])
def test_shard_split_matches_jax(n, index, count, worker, workers):
    names = [f"s{i}" for i in range(n)]
    assert tario.shard_split(names, index, count, worker, workers) == \
        jtario.shard_split(names, index, count, worker, workers)


def test_expand_shards_matches_jax(tmp_path):
    for name in ("b.tar", "a.tar", "c.txt"):
        (tmp_path / name).write_bytes(b"")
    for arg in (str(tmp_path), str(tmp_path / "a.tar"), "pipe:cat x",
                ["u", "v"], ("w",)):
        assert tario.expand_shards(arg) == jtario.expand_shards(arg)


# --- parallel_map and prefetch ----------------------------------------------

@pytest.mark.parametrize("workers", [0, 4])
def test_parallel_map_order_and_errors_match_jax(workers):
    def f(x):
        if x == 13:
            raise ValueError("boom")
        time.sleep(0.001 * (x % 3))
        return x * x

    def run(pmap):
        out = []
        with pytest.raises(ValueError, match="boom"):
            for y in pmap(f, range(20), workers=workers, inflight=5):
                out.append(y)
        return out

    got = run(prefetch.parallel_map)
    assert got == run(jprefetch.parallel_map) == [x * x for x in range(13)]


def test_prefetch_order_and_errors_match_jax():
    def boom():
        yield from range(5)
        raise KeyError("producer failed")

    for mod in (prefetch, jprefetch):
        assert list(mod.prefetch(iter(range(7)), size=2)) == list(range(7))
        it = mod.prefetch(boom(), size=1)
        assert [next(it) for _ in range(5)] == list(range(5))
        with pytest.raises(KeyError, match="producer failed"):
            next(it)
        with pytest.raises(StopIteration):
            next(mod.prefetch(iter(())))


# --- seg maps and annotator geometry ----------------------------------------

def _labels(seed, h=24, w=20):
    r = np.random.default_rng(seed)
    return (r.integers(-1, 133, (h, w)), r.integers(0, 2, (h, w)),
            r.integers(-1, 20, (h, w)), r.integers(0, 2, (h, w)),
            r.integers(0, 6, (h, w)))


def _assemble_into(mod):
    out = np.full((24, 20, 159), 7.0, np.float32)
    prev = mod.assemble_seg_map_into(out, *_labels(1))
    first = out.copy()
    mod.assemble_seg_map_into(out, *_labels(2), prev=prev)
    return first, out


def _boxes(seed):
    r = np.random.default_rng(seed)
    return [list(b) for b in r.uniform(-40, 560, (12, 4))] + \
        [[10, 10, 5, 30], [0, 0, 15.9, 40], [3, 4, 60, 70, 9]]


def _landmarks(seed, n=2):
    r = np.random.default_rng(seed)
    return r.random((n, 68, 2)) * np.array([70, 50]) - 5


GEOMETRY = {
    "assemble_seg_map": lambda m: m.assemble_seg_map(*_labels(0)),
    "assemble_seg_map_into": _assemble_into,
    "edges_from_instances": lambda m: m.edges_from_instances(
        np.random.default_rng(3).integers(0, 4, (19, 23))),
    "sanitize_bboxes": lambda m: [m.sanitize_bboxes(_boxes(4)),
                                  m.sanitize_bboxes(_boxes(4), 256, 8)],
    "pad_boxes": lambda m: [m.pad_boxes(_boxes(5)[:3], 6),
                            m.pad_boxes(_boxes(5), 6), m.pad_boxes([], 2)],
    "pack_seg_labels": lambda m: m.pack_seg_labels(*_labels(6)[:4]),
}
ANNOTATE = {
    "bilinear_resize": lambda m: [
        m.bilinear_resize(np.random.default_rng(7).random((2, 13, 17)),
                          31, 9, align_corners=a) for a in (False, True)],
    "prepare_human_input": lambda m: m.prepare_human_input(
        np.random.default_rng(8).random((1, 3, 40, 30)) * 255),
    "human_logits_to_mask": lambda m: m.human_logits_to_mask(
        np.random.default_rng(9).standard_normal((1, 20, 30, 30)), 45, 37),
    "masks_to_boxes": lambda m: [
        m.masks_to_boxes(np.random.default_rng(10).random((4, 20, 30))
                         > 0.97),
        m.masks_to_boxes(np.zeros((2, 5, 5))),
        m.masks_to_boxes(np.zeros((0, 5, 5)))],
    "panoptic_thing_boxes": lambda m: [
        m.panoptic_thing_boxes(np.random.default_rng(11).choice(
            [3001, 3002, 79001, 80001, 120000], (30, 40))),
        m.panoptic_thing_boxes(np.full((4, 4), 90000))],
    "draw_closed_contour": lambda m: m.draw_closed_contour(
        np.zeros((30, 40), np.uint8),
        np.array([[2, 3], [35, 8], [41, 31], [-3, 20]]), 3),
    "draw_face_mask": lambda m: m.draw_face_mask(
        np.zeros((50, 70), np.uint8), _landmarks(12, 1)[0]),
    "faces_to_mask": lambda m: m.faces_to_mask((50, 70), _landmarks(13)),
}


@pytest.mark.parametrize("name", sorted(GEOMETRY))
def test_segmap_functions_match_jax(name):
    assert_same(GEOMETRY[name](segmap), GEOMETRY[name](jsegmap))


@pytest.mark.parametrize("name", sorted(ANNOTATE))
def test_annotate_functions_match_jax(name):
    assert_same(ANNOTATE[name](annotate), ANNOTATE[name](jannotate))


def test_one_hot_seg_matches_jax():
    """torch one-hot seg maps (plain and from packed labels) equal the jnp
    ones and the numpy assembly."""
    lab = _labels(14)
    want = np.asarray(jsegmap.one_hot_seg(*map(jnp.asarray, lab)))
    got = segmap.one_hot_seg(*map(torch.from_numpy, lab))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, jsegmap.assemble_seg_map(*lab))
    packed = jsegmap.pack_seg_labels(lab[0], lab[1] + lab[3], lab[2],
                                     lab[4])
    np.testing.assert_array_equal(
        segmap.one_hot_seg_packed(torch.from_numpy(packed)[None]).numpy(),
        np.asarray(jsegmap.one_hot_seg_packed(packed[None])))


# --- datasets and batching --------------------------------------------------

@pytest.mark.parametrize("workers", [0, 4])
@pytest.mark.parametrize("need_seg", [True, False])
def test_web_dataset_samples_match_jax(tmp_path, workers, need_seg):
    """Both shards, in order, with the missing npz and the bad JPEG
    skipped, and the same per-process split."""
    paths = shards(tmp_path)
    kw = dict(resolution=32, need_seg=need_seg, workers=workers)
    with pytest.warns(UserWarning, match="skipping sample"):
        got = list(dataset.PreprocessedWebDataset(
            os.path.dirname(paths[0]), **kw))
    with pytest.warns(UserWarning):
        want = list(jdataset.PreprocessedWebDataset(
            os.path.dirname(paths[0]), **kw))
    assert len(got) == 12 - 3
    assert all(s["image"].shape == (32, 32, 3) for s in got)
    assert ("mask" in got[0]) == need_seg
    assert_same(got, want)
    split = dataset.PreprocessedWebDataset(paths, 32, 1, 2, workers=workers)
    assert [s["caption"] for s in split] == [
        s["caption"] for s in jdataset.PreprocessedWebDataset(
            paths, 32, 1, 2, workers=workers)]


def write_local(tmp_path, n=3):
    """An image dir of n JPEGs (SIZES) and their annotator npz triplets,
    written with numpy draws (no annotator)."""
    img_dir, pre = tmp_path / "imgs", tmp_path / "pre"
    img_dir.mkdir()
    pre.mkdir()
    rng = np.random.default_rng(20)
    for i in range(n):
        h, w = SIZES[i % len(SIZES)]
        (img_dir / f"im{i}.jpg").write_bytes(_jpeg(rng, h, w))
        z = np.load(io.BytesIO(_npz(rng, h, w)))
        np.savez(pre / f"im{i}_panoptic.npz", seg_panoptic=z["seg_panoptic"],
                 edges=z["edge_panoptic"], box_things=z["box_things"])
        np.savez(pre / f"im{i}_human.npz", seg_human=z["seg_human"],
                 edges=z["edge_human"])
        np.savez(pre / f"im{i}_face.npz", seg_face=z["seg_face"],
                 box_face=z["box_face"])
    return str(img_dir), str(pre)


def test_local_url_and_concat_datasets_match_jax(tmp_path):
    """PreprocessedLocalDataset (the crop draws in order), URLImageDataset
    on cached images (no fetch) and ConcatDataset of both, with negative
    indices."""
    img_dir, pre = write_local(tmp_path)
    manifest = tmp_path / "list.tsv"
    manifest.write_text("".join(f"http://unreachable.invalid/{i}.jpg\tim{i}\n"
                                for i in range(3)))

    def build(mod):
        local = mod.PreprocessedLocalDataset(img_dir, pre, 24, seed=3)
        url = mod.URLImageDataset(str(manifest), img_dir, pre, 16, seed=4)
        both = mod.ConcatDataset([local, url])
        items = [local[i] for i in (0, 2, 1, 0)]
        items += [url[i] for i in (1, 0)]
        items += [both[i] for i in (0, 4, -1, -6)]
        return items, len(both), [both.get_true_idx(i) for i in range(-6, 6)]

    got, want = build(dataset), build(jdataset)
    assert got[1] == 6 and got[0][0]["mask"].shape == (24, 24, 159)
    assert_same(got, want)
    with pytest.raises(ValueError):
        dataset.ConcatDataset([[1]]).get_true_idx(-2)


def test_collate_and_batch_iterator_match_jax():
    rng = np.random.default_rng(30)
    samples = [dict(image=rng.random((8, 8, 3)),
                    mask=rng.random((8, 8, 159)).astype(np.float64),
                    box_things=_boxes(31 + i)[:i], caption=f"c{i}")
               for i in range(5)]
    samples[2].pop("caption")
    samples[3].pop("box_things")
    for kw in (dict(), dict(max_boxes=2, need_seg=False)):
        assert_same(dataset.collate(samples, **kw),
                    jdataset.collate(samples, **kw))
    for kw in (dict(), dict(drop_last=False), dict(need_seg=False)):
        assert_same(list(dataset.batch_iterator(samples, 2, **kw)),
                    list(jdataset.batch_iterator(samples, 2, **kw)))


def _seg_cfg(in_channels):
    return VQModelConfig(in_channels=in_channels, out_channels=in_channels,
                         channels=(32, 32), resolution=32,
                         attn_resolutions=())


@pytest.mark.parametrize("kind", ["webdataset", "local_npz"])
@pytest.mark.parametrize("need_seg", [True, False])
def test_cli_data_iter_matches_jax(tmp_path, kind, need_seg):
    """3 batches of the port's ``data_iter`` (seg maps for a 159-channel
    model, none for a 3-channel one) against ``mas_tpu.cli._data_iter``
    in the matching mode; local_npz runs past an epoch's end."""
    from mas_tpu.cli import _data_iter
    from mas_tpu_torch.cli import data_iter

    if kind == "webdataset":
        cfg = {"kind": kind, "shards": os.path.dirname(shards(tmp_path)[0]),
               "resolution": 32, "max_boxes": 2}
    else:
        img_dir, pre = write_local(tmp_path)
        cfg = {"kind": kind, "image_dir": img_dir, "preprocessed_dir": pre,
               "resolution": 24, "seed": 5, "prefetch": 1}
    mode = "pretrain_segmentation" if need_seg else "pretrain_image"
    got = data_iter(cfg, 2, _seg_cfg(159 if need_seg else 3))
    want = _data_iter(cfg, mode, 2)
    got = [next(got) for _ in range(3)]
    want = [next(want) for _ in range(3)]
    assert ("mask" in got[0]) == need_seg
    assert_same(got, want)
