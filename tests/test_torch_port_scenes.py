"""The port's learnable synthetic scenes, its HuggingFace tokenizer adapter
and ``vqvae_bce_loss`` vs the JAX package, on CPU.

``StructuredSceneBatches`` is numpy in both packages, so its batches are
held bitwise for one seed on every path (fresh scenes, the cached pool's
rotating buffers, a pool saved to disk by either package and memory-mapped
by the other), with ``compact`` and ``image_u8`` each on and off, at 32^2
and 64^2.  The slice as a whole: three micro-steps of
``run_pretrain_segmentation`` in each package on its own packed scene
labels, from JAX's initial variables (tiny seg model, fp32).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

import mas_tpu.train.loop as jloop
from mas_tpu.data import dataset as jdataset
from mas_tpu.data.tokenizer import HFTokenizerAdapter as JHFTokenizerAdapter
from mas_tpu.losses.seg import vqvae_bce_loss as jvqvae_bce_loss
from mas_tpu.models.vqvae import VQModel as JVQModel
from mas_tpu.utils.config import CodebookConfig as JCodebookConfig
from mas_tpu.utils.config import OptimizerConfig as JOptimizerConfig
from mas_tpu.utils.config import SegLossConfig as JSegLossConfig
from mas_tpu.utils.config import TrainConfig as JTrainConfig
from mas_tpu.utils.config import VQModelConfig as JVQModelConfig

import mas_tpu_torch.train.loop as loop
from mas_tpu_torch.data import dataset
from mas_tpu_torch.data.segmap import one_hot_seg_packed
from mas_tpu_torch.data.tokenizer import HFTokenizerAdapter
from mas_tpu_torch.losses.seg import vqvae_bce_loss
from mas_tpu_torch.models.codebook import codebook_init_state
from mas_tpu_torch.models.vqvae import VQModel
from mas_tpu_torch.train.state import VQTrainState, make_adam
from mas_tpu_torch.utils.config import (CodebookConfig, OptimizerConfig,
                                        SegLossConfig, TrainConfig,
                                        VQModelConfig)
from mas_tpu_torch.utils.weights import vq_from_flax

FLAGS = [(False, False), (True, False), (False, True), (True, True)]


def _pair(**kw):
    return (jdataset.StructuredSceneBatches(**kw),
            dataset.StructuredSceneBatches(**kw))


def _take(source, n):
    """``n`` batches of ``source``, each copied before the next is drawn
    (the cached path reuses its buffers)."""
    it = iter(source)
    return [{k: v.copy() for k, v in next(it).items()} for _ in range(n)]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, (i, k)
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{i} {k}")


def _refuse_scenes(source):
    def scene():
        raise AssertionError("the pool must load from disk")
    source._scene = scene
    return source


@pytest.mark.parametrize("resolution", [32, 64])
@pytest.mark.parametrize("compact,image_u8", FLAGS)
def test_fresh_batches_match_jax(resolution, compact, image_u8):
    """cache_scenes 0: every batch draws new scenes; images (float or
    uint8), mask or packed labels and both box sets bitwise."""
    jsrc, src = _pair(batch_size=2, resolution=resolution, seed=3,
                      compact=compact, image_u8=image_u8)
    want, got = _take(jsrc, 2), _take(src, 2)
    _assert_batches_equal(got, want)
    key = "seg_packed" if compact else "mask"
    assert got[0][key].dtype == (np.int16 if compact else np.float32)
    assert got[0]["image"].dtype == (np.uint8 if image_u8 else np.float32)
    if resolution == 64:       # at 32^2 every box is under 16 px a side
        assert any((b["bbox_obj"] > 0).any() for b in got)


def test_packed_labels_expand_to_the_dense_mask():
    """A compact batch's labels, expanded by ``one_hot_seg_packed``, are
    the dense instance's mask for the same seed, bitwise (fresh and
    cached)."""
    for cache in (0, 4):
        kw = dict(batch_size=2, resolution=32, seed=9, cache_scenes=cache)
        packed = _take(dataset.StructuredSceneBatches(compact=True, **kw), 3)
        dense = _take(dataset.StructuredSceneBatches(**kw), 3)
        for p, d in zip(packed, dense):
            assert torch.equal(one_hot_seg_packed(
                torch.from_numpy(p["seg_packed"])),
                torch.from_numpy(d["mask"]))


@pytest.mark.parametrize("resolution,compact,image_u8",
                         [(32,) + f for f in FLAGS]
                         + [(64, False, False), (64, True, True)])
def test_cached_batches_match_jax(resolution, compact, image_u8):
    """12 batches of 3 from an 8-scene pool: 6 passes, each in a new
    order, 2 scenes a pass dropped, the 8 rotating buffers reused (and the
    dense mask's cleared entries with them)."""
    jsrc, src = _pair(batch_size=3, resolution=resolution, seed=4,
                      cache_scenes=8, compact=compact, image_u8=image_u8)
    _assert_batches_equal(_take(src, 12), _take(jsrc, 12))
    it = iter(src)
    first = [next(it) for _ in range(9)]
    assert first[8] is first[0] and first[7] is not first[0]


@pytest.mark.parametrize("compact,image_u8", FLAGS)
def test_saved_pools_interchange(tmp_path, compact, image_u8):
    """A pool saved by either package has the same directory name and
    files, byte for byte, and loads in the other with ``_scene`` refusing:
    the loaded batches equal the saving package's loaded batches; the
    view's scene tuples are the ones saved."""
    kw = dict(batch_size=2, resolution=32, seed=7, cache_scenes=5,
              compact=compact, image_u8=image_u8)
    saved = {}
    for name, module in (("jax", jdataset), ("port", dataset)):
        d = tmp_path / name
        fresh = module.StructuredSceneBatches(pool_cache_dir=str(d), **kw)
        captured = []
        save = fresh._save_pool
        fresh._save_pool = lambda scenes: captured.extend(scenes) or \
            save(scenes)
        next(iter(fresh))
        (pool,) = list(d.iterdir())
        saved[name] = (pool, captured)
    (jpool, jscenes), (pool, scenes) = saved["jax"], saved["port"]
    assert pool.name == jpool.name == (
        f"scenes_v{dataset._POOL_FORMAT_VERSION}_r32_n5_s7_m6")
    files = sorted(p.name for p in pool.iterdir())
    assert files == sorted(p.name for p in jpool.iterdir())
    assert files == sorted([n + ".npy" for n in dataset._POOL_FIELDS]
                           + ["box.npy", "box_off.npy", "fbox.npy",
                              "fbox_off.npy"])
    for f in files:
        assert (pool / f).read_bytes() == (jpool / f).read_bytes(), f

    for saver in ("jax", "port"):
        d = str(tmp_path / saver)
        want = _take(_refuse_scenes(jdataset.StructuredSceneBatches(
            pool_cache_dir=d, **kw)), 6)
        loader = _refuse_scenes(dataset.StructuredSceneBatches(
            pool_cache_dir=d, **kw))
        view = loader._load_pool()
        assert isinstance(view, dataset._ScenePoolView) and len(view) == 5
        for i, scene in enumerate(scenes):
            loaded = view[i]
            assert len(loaded) == 7
            for j in range(5):
                assert loaded[j].dtype == scene[j].dtype
                np.testing.assert_array_equal(loaded[j], scene[j])
            for j in (5, 6):
                np.testing.assert_array_equal(
                    loaded[j], np.asarray(scene[j], np.float32).reshape(-1, 4))
        _assert_batches_equal(_take(loader, 6), want)


def test_pool_refusals_match_jax(tmp_path, capsys):
    """Fields of disagreeing lengths raise ValueError in ``_ScenePoolView``;
    a pool that cannot be read is reported and drawn again (the fresh
    pool's batches); cache_scenes < batch_size raises as in JAX."""
    kw = dict(batch_size=2, resolution=32, seed=2, cache_scenes=4,
              compact=True)
    d = str(tmp_path)
    src = dataset.StructuredSceneBatches(pool_cache_dir=d, **kw)
    want = _take(src, 3)
    path = src._pool_path()

    hum = np.load(os.path.join(path, "hum.npy"))
    np.save(os.path.join(path, "hum.npy"), hum[:-1])
    for view in (jdataset._ScenePoolView, dataset._ScenePoolView):
        with pytest.raises(ValueError, match="field lengths disagree"):
            view(path)
    np.save(os.path.join(path, "hum.npy"), hum)
    assert len(dataset._ScenePoolView(path)) == 4

    with open(os.path.join(path, "pan.npy"), "wb") as f:
        f.write(b"not a numpy file")
    for module in (jdataset, dataset):
        got = _take(module.StructuredSceneBatches(pool_cache_dir=d, **kw), 3)
        _assert_batches_equal(got, want)
        assert "unreadable" in capsys.readouterr().out

    messages = []
    for module in (jdataset, dataset):
        with pytest.raises(ValueError) as exn:
            module.StructuredSceneBatches(3, 32, cache_scenes=2)
        messages.append(str(exn.value))
    assert messages[0] == messages[1]
    src = dataset.StructuredSceneBatches(2, 32, cache_scenes=2, workers=7)
    assert src.workers == 7


def test_segmap_channel_slices_match_jax():
    from mas_tpu.data import segmap as jsegmap
    from mas_tpu_torch.data import segmap

    for name in ("PANOPTIC_SLICE", "HUMAN_SLICE", "FACE_SLICE",
                 "EDGE_CHANNEL", "NUM_SEG_CHANNELS"):
        assert getattr(segmap, name) == getattr(jsegmap, name), name
    seg = np.arange(159)
    assert [len(seg[s]) for s in (segmap.PANOPTIC_SLICE, segmap.HUMAN_SLICE,
                                  segmap.FACE_SLICE)] == [133, 20, 5]


class StubTokenizer:
    """Word lengths as ids, as ``tests/test_surface.py``'s stub."""

    def encode(self, text, add_special_tokens=False):
        assert not add_special_tokens
        return [len(w) for w in text.split()]


def test_hf_tokenizer_adapter_matches_jax():
    captions = ["a bb ccc", "dddd eeeee ffffff ggggggg hhh", "", 12345,
                None]
    for length in (4, 8):
        want = JHFTokenizerAdapter(StubTokenizer(), text_length=length)(
            captions)
        got = HFTokenizerAdapter(StubTokenizer(), text_length=length)(
            captions)
        assert got.dtype == np.int32 and got.shape == (5, length)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], [2, 3, 4, 0, 0, 0, 0, 0])
    np.testing.assert_array_equal(got[2], 0)
    np.testing.assert_array_equal(got[3], [6, 0, 0, 0, 0, 0, 0, 0])


def test_tokenizer_module_does_not_import_transformers():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, mas_tpu_torch.data.tokenizer as t; "
         "assert hasattr(t, 'HFTokenizerAdapter'); "
         "print('transformers' in sys.modules)"],
        capture_output=True, text=True, check=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.stdout.strip() == "False"


@pytest.mark.parametrize("spec", [
    {}, dict(codebook_weight=0.5, face_weight=5.0)])
def test_vqvae_bce_loss_matches_jax(spec):
    r = np.random.default_rng(len(spec))
    logits = (r.standard_normal((2, 8, 8, 159)) * 3).astype(np.float32)
    targets = (r.random((2, 8, 8, 159)) < 0.1).astype(np.float32)
    targets[..., 153:158] = r.random((2, 8, 8, 5)) < 0.5     # face channels
    q_loss = np.float32(0.37)
    want = jvqvae_bce_loss(jnp.asarray(q_loss), jnp.asarray(targets),
                           jnp.asarray(logits), JSegLossConfig(**spec))
    got = vqvae_bce_loss(torch.tensor(q_loss), torch.from_numpy(targets),
                         torch.from_numpy(logits), SegLossConfig(**spec))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


class _Rows:
    """A logger of both packages' loops that keeps the scalars."""

    image_period = 10 ** 9

    def __init__(self, log_dir):
        self.log_dir = log_dir
        self.rows = []

    def log(self, step=None, img=None, img_rec=None, **scalars):
        self.rows.append((step, {k: float(v) for k, v in scalars.items()}))


# A seg model smaller than the other seg tests' (no attention, two levels),
# to keep JAX's compiles short; 159 channels as every seg model.
SCENE_SEG = dict(in_channels=159, out_channels=159, channels=(32, 32),
                 resolution=32, attn_resolutions=(), z_channels=32,
                 embed_dim=32, num_res_blocks=1)
SCENE_CB = dict(codebook_size=16, codebook_dim=32, reservoir_size=64,
                init_steps=2, samples_per_image=2, kmeans_iters=3)
# Adam eps 1e-3, as the other seg tests: at 1e-8 a conv bias ahead of a
# normalization, whose gradient is rounding, moves by +-lr either way.
OPT = dict(lr=1e-3, eps=1e-3, accumulate_grad=3)


def test_run_pretrain_segmentation_on_packed_scenes_matches_jax(
        tmp_path, monkeypatch):
    """Three micro-steps from counter 0 (pass-through and reservoir
    collection; accumulate_grad 3: one Adam update) of each package's
    ``run_pretrain_segmentation`` on its own compact scene batches, from
    the initial variables JAX's loop makes, carried over by the weight
    bridge: losses rtol 1e-5 at every step, parameters and BN statistics
    atol 1e-6 after the update, as ``test_seg_train_step_matches_jax``
    holds them."""
    common = dict(mode="pretrain_segmentation", total_steps=3, batch_size=2,
                  log_period=1, save_period=3, allow_replicated_batch=True)
    jtrain = JTrainConfig(**common, optimizer=JOptimizerConfig(**OPT),
                          checkpoint_dir=str(tmp_path / "jax"))
    train = TrainConfig(**common, optimizer=OptimizerConfig(**OPT),
                        checkpoint_dir=str(tmp_path / "port"))
    jmodel_cfg = JVQModelConfig(**SCENE_SEG,
                                codebook=JCodebookConfig(**SCENE_CB))
    model_cfg = VQModelConfig(**SCENE_SEG,
                              codebook=CodebookConfig(**SCENE_CB))
    kw = dict(batch_size=2, resolution=32, seed=5, cache_scenes=4,
              compact=True)

    # JAX's loop builds its state with create_vq_train_state; its init runs
    # compiled (the same variables, without one compile an operation) and
    # a copy is kept before the step donates them.
    monkeypatch.setattr(JVQModel, "init", lambda self, *a: jax.jit(
        lambda *b: nn.Module.init(self, *b))(*a))
    initial = {}
    create = jloop.create_vq_train_state

    def recorded(*args):
        st = create(*args)
        initial.update(jax.tree.map(lambda a: np.array(a, copy=True), {
            "params": st.params, "batch_stats": st.batch_stats}))
        return st

    monkeypatch.setattr(jloop, "create_vq_train_state", recorded)
    # JAX's end-of-run checkpoint is not compared (and orbax takes seconds
    # to import): its loop records the save instead
    saves = []
    monkeypatch.setattr(jloop, "save_checkpoint",
                        lambda d, st, step: saves.append(step))
    monkeypatch.setattr(jloop, "latest_step",
                        lambda d: saves[-1] if saves else None)
    jlog = _Rows(str(tmp_path / "jlogs"))
    jstate = jloop.run_pretrain_segmentation(
        jtrain, jmodel_cfg, ({"seg_packed": b["seg_packed"]} for b in
                             jdataset.StructuredSceneBatches(**kw)),
        logger=jlog)

    model = VQModel(model_cfg)
    model.load_state_dict(vq_from_flax(initial, model_cfg), strict=True)
    opt = make_adam(train.optimizer, model.named_parameters(),
                    rescale_lr=False)
    state = VQTrainState(0, model, codebook_init_state(model_cfg.codebook),
                         opt)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    monkeypatch.setattr(loop, "build_seg_state", lambda *a: state)
    log = _Rows(str(tmp_path / "logs"))
    out = loop.run_pretrain_segmentation(
        train, model_cfg, ({"seg_packed": b["seg_packed"]} for b in
                           dataset.StructuredSceneBatches(**kw)),
        device="cpu", logger=log)
    assert out is state and state.step == 3 and state.opt.count == 1
    assert int(jstate.step) == 3 and saves == [3]
    assert state.vq_state.counter == 3 and loop.latest_step(
        train.checkpoint_dir) == 3
    assert state.vq_state.filled == int(jstate.vq_state.filled) > 0
    assert [s for s, _ in log.rows] == [s for s, _ in jlog.rows] == [1, 2, 3]
    for (_, got), (_, want) in zip(log.rows, jlog.rows):
        for k in ("loss", "q_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    ref = vq_from_flax(jax.tree.map(np.asarray, {
        "params": jstate.params, "batch_stats": jstate.batch_stats}),
        model_cfg)
    moved = 0
    for name, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[name].numpy(), atol=1e-6,
                                   err_msg=name)
        moved += not torch.equal(v, before[name])
    assert moved > len(ref) // 2
