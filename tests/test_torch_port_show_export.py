"""The port's seg-map ``Visualizer``, ``--mode show``, ``--mode export``, a
checkpoint dir named as a checkpoint, and ``python -m mas_tpu_torch``'s
guard and ``error.log``, on CPU, held to the JAX package where it has a
counterpart.

Sizes are tiny (the seg model of ``test_torch_port_vq.py``, 32^2; the
transformer of ``test_torch_port_models.py``).  ``Visualizer.colorize``
equals JAX's to 1e-6; an export equals JAX's ``export_vqbase_state`` /
``export_transformer_state`` of the same flax variables bitwise (keys,
shapes, dtypes, values) and reads back through ``mas_tpu.utils.
torch_import`` to those variables bitwise.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from mas_tpu.models.transformer import MakeAScene as JMakeAScene
from mas_tpu.models.vqvae import VQModel as JVQModel
from mas_tpu.utils import torch_export as jexport
from mas_tpu.utils import torch_import as jimport
from mas_tpu.utils.config import CodebookConfig as JCodebookConfig
from mas_tpu.utils.config import TransformerConfig as JTransformerConfig
from mas_tpu.utils.config import VQModelConfig as JVQModelConfig
from mas_tpu.utils.logging import Visualizer as JVisualizer

from mas_tpu_torch.cli import main
from mas_tpu_torch.data.dataset import SyntheticSegBatches
from mas_tpu_torch.models.vqvae import VQModel
from mas_tpu_torch.utils import checkpoint
from mas_tpu_torch.utils.config import (TrainConfig, TransformerConfig,
                                        VQModelConfig)
from mas_tpu_torch.utils.export import export_state
from mas_tpu_torch.utils.logging import Logger, Visualizer
from mas_tpu_torch.utils.weights import (load_reference_pt,
                                         transformer_from_flax, vq_from_flax)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_models import T_TINY  # noqa: E402
from test_torch_port_pipeline import VQ_SLICE  # noqa: E402
from test_torch_port_vq import CB_TINY, SEG_TINY  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _write_config(tmp_path, name, raw):
    path = tmp_path / name
    path.write_text(json.dumps(raw))
    return str(path)


# --- Visualizer ----------------------------------------------------------------

@pytest.mark.parametrize("logits", [False, True])
def test_visualizer_colorize_matches_jax(tmp_path, logits):
    """A synthetic one-hot mask and random logits (face and edge around
    the sigmoid 0.2 mask): every group's colors to 1e-6."""
    if logits:
        seg = np.random.default_rng(1).normal(
            -1.0, 1.5, (2, 16, 16, 159)).astype(np.float32)
    else:
        seg = next(iter(SyntheticSegBatches(2, 16, 2)))["mask"]
    got = Visualizer(str(tmp_path), seed=3).colorize(seg, logits=logits)
    want = JVisualizer(str(tmp_path), seed=3).colorize(seg, logits=logits)
    assert list(got) == list(want) == ["panoptic", "human", "face", "edge"]
    for key, v in want.items():
        assert got[key].shape == (2, 16, 16, 3)
        np.testing.assert_allclose(got[key], v, atol=1e-6, err_msg=key)


def _panel_size(batch, res, panels=9):
    """(width, height) of a Visualizer panel grid: ``panels`` columns of
    ``res`` + 2 pixels, ``batch`` rows."""
    return (panels * (res + 2) + 2, batch * (res + 2) + 2)


def test_visualizer_panel_matches_jax(tmp_path):
    seg = next(iter(SyntheticSegBatches(2, 16, 4)))["mask"]
    rec = np.random.default_rng(5).normal(size=seg.shape).astype(np.float32)
    rgb = np.random.default_rng(6).random((2, 16, 16, 3), np.float32)
    paths = [cls(str(tmp_path / name))(7, image=rgb, seg=seg, seg_rec=rec)
             for cls, name in ((Visualizer, "port"), (JVisualizer, "jax"))]
    assert [os.path.basename(p) for p in paths] == ["result_7.jpg"] * 2
    got, want = (np.asarray(Image.open(p)) for p in paths)
    assert Image.open(paths[0]).size == _panel_size(2, 16)
    np.testing.assert_array_equal(got, want)


# --- show ----------------------------------------------------------------------

def _seg_train_config(tmp_path, total_steps=2):
    from test_torch_port_train import _cli_config

    return _cli_config(tmp_path, total_steps, False)


def _show_config(tmp_path, checkpoint_dir, n_samples, batch=2):
    raw = {"train": {"mode": "show", "batch_size": batch,
                     "checkpoint_dir": checkpoint_dir},
           "model": dict(SEG_TINY, codebook=CB_TINY),
           "n_samples": n_samples,
           "data": {"kind": "synthetic", "resolution": 32}}
    return _write_config(tmp_path, "show.json", raw)


def _read_jpgs(paths, size):
    for p in paths:
        img = Image.open(p)
        assert img.size == size, (p, img.size)
        assert np.isfinite(np.asarray(img, np.float32)).all()


@pytest.mark.parametrize("n_samples,batch", [(5, 2), (4, 4)])
def test_run_show_writes_one_panel_per_batch(tmp_path, n_samples, batch):
    """No checkpoint: seeded random weights; ceil(n_samples / batch)
    readable panels of the expected size."""
    from mas_tpu_torch.train.loop import run_show

    train_cfg = TrainConfig(checkpoint_dir=str(tmp_path / "none"),
                            batch_size=batch)
    model_cfg = VQModelConfig(**SEG_TINY, codebook=CB_TINY)
    paths = run_show(train_cfg, model_cfg,
                     iter(SyntheticSegBatches(batch, 32, 0)),
                     n_samples=n_samples, out_dir=str(tmp_path / "res"),
                     device="cpu")
    assert len(paths) == math.ceil(n_samples / batch)
    assert paths[-1].endswith(f"result_{(len(paths) - 1) * batch}.jpg")
    _read_jpgs(paths, _panel_size(batch, 32))


def test_cli_show_from_a_trained_checkpoint_dir(tmp_path, monkeypatch,
                                                capsys):
    """--mode pretrain_segmentation, then --mode show from its dir: the
    model is the latest checkpoint's, the panels go to results/ and their
    paths are printed."""
    monkeypatch.chdir(tmp_path)
    assert main(["--config", _seg_train_config(tmp_path), "--device",
                 "cpu"]) == 0
    capsys.readouterr()
    assert main(["--config", _show_config(tmp_path, str(tmp_path / "ck"), 3),
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "resumed from step 2"
    assert out[1:] == [os.path.join("results", f"result_{i}.jpg")
                       for i in (0, 2)]
    _read_jpgs([tmp_path / p for p in out[1:]], _panel_size(2, 32))


@pytest.mark.parametrize("packed", [False, True])
def test_seg_loop_logs_colorized_grids(tmp_path, packed):
    """At image_period the VQ-SEG loop saves the colorized panoptic group
    of the first seg maps above their reconstructions (dense or packed
    labels), as the JAX loop does."""
    from mas_tpu.data.segmap import pack_seg_labels

    from mas_tpu_torch.train.loop import run_pretrain_segmentation

    r = np.random.default_rng(7)
    pan, hum = r.integers(-1, 133, (2, 32, 32)), r.integers(-1, 20,
                                                            (2, 32, 32))
    face, edge = r.integers(0, 6, (2, 32, 32)), r.integers(0, 2, (2, 32, 32))
    if packed:
        batch = {"seg_packed": np.stack([pack_seg_labels(
            pan[i], edge[i], hum[i], face[i]) for i in range(2)])}
    else:
        batch = next(iter(SyntheticSegBatches(2, 32, 1)))
    train_cfg = TrainConfig(checkpoint_dir=str(tmp_path / "ck"),
                            total_steps=2, batch_size=2, log_period=1)
    logs = str(tmp_path / "logs")
    run_pretrain_segmentation(
        train_cfg, VQModelConfig(**SEG_TINY, codebook=CB_TINY),
        [batch, batch], device="cpu",
        logger=Logger(logs, image_period=2, use_tensorboard=False))
    assert sorted(f for f in os.listdir(logs) if f.endswith(".jpg")) == \
        ["samples_2.jpg"]
    # inputs (2) and reconstructions (2) in one row of a 4-wide grid
    _read_jpgs([os.path.join(logs, "samples_2.jpg")], (4 * 34 + 2, 36))


# --- export --------------------------------------------------------------------

def _vq_variables(jcfg, seed=0):
    r = jcfg.resolution
    variables = _np(JVQModel(jcfg).init(jax.random.PRNGKey(seed),
                                        jnp.zeros((1, r, r, 159))))
    rng = np.random.default_rng(seed + 1)
    variables["batch_stats"]["quant_bn"] = {
        "mean": rng.normal(size=jcfg.embed_dim).astype(np.float32),
        "var": rng.uniform(0.5, 1.5, jcfg.embed_dim).astype(np.float32)}
    return variables


def _transformer_params(jcfg, seed=0):
    return _np(JMakeAScene(jcfg).init(
        jax.random.PRNGKey(seed),
        jnp.zeros((1, jcfg.text_length), jnp.int32),
        jnp.zeros((1, jcfg.seg_length), jnp.int32),
        jnp.zeros((1, jcfg.image_length), jnp.int32)))["params"]


def _save_source(tmp_path, state, source):
    """A port training checkpoint dir (``source`` 'dir') or a bare
    state_dict file ('file') holding ``state``; returns its path."""
    if source == "file":
        path = str(tmp_path / "weights.pt")
        torch.save(state, path)
        return path
    ck = str(tmp_path / "ck")
    os.makedirs(ck)
    torch.save({"step": 1, "model": {k: torch.zeros_like(v)
                                     for k, v in state.items()}},
               checkpoint.checkpoint_path(ck, 1))
    torch.save({"step": 3, "model": state, "optimizer": {"count": 1}},
               checkpoint.checkpoint_path(ck, 3))
    return ck


def _assert_bitwise(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        ref = torch.from_numpy(np.array(v))
        assert got[k].dtype == ref.dtype, (k, got[k].dtype, ref.dtype)
        assert got[k].shape == ref.shape, k
        assert torch.equal(got[k], ref), k


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    else:
        assert got.dtype == np.asarray(want).dtype, path
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=path)


@pytest.mark.parametrize("source", ["dir", "file"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_vq_matches_jax_and_round_trips(tmp_path, monkeypatch, capsys,
                                               source, dtype):
    """--mode export of the seg model whose weights came from
    ``vq_from_flax``: JAX's ``export_vqbase_state`` bitwise (fp32 weights
    from a bf16 config too, num_batches_tracked int64 0), and back through
    ``convert_vqbase_state`` to the flax variables bitwise."""
    monkeypatch.chdir(tmp_path)
    model_raw = dict(SEG_TINY, codebook=CB_TINY, compute_dtype=dtype)
    jcfg = JVQModelConfig(**{**model_raw, "codebook": JCodebookConfig(
        **CB_TINY)})
    variables = _vq_variables(jcfg)
    cfg = VQModelConfig.from_dict(model_raw)
    ck = _save_source(tmp_path, vq_from_flax(variables, cfg), source)
    out = str(tmp_path / "vq.pt")
    path = _write_config(tmp_path, "export.json", {
        "train": {"mode": "export"}, "model": model_raw, "checkpoint": ck,
        "output": out})
    assert main(["--config", path, "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == out
    got = torch.load(out, weights_only=True)
    _assert_bitwise(got, jexport.export_vqbase_state(variables, jcfg))
    back = jimport.convert_vqbase_state(
        {k: v.numpy() for k, v in got.items()}, jcfg)
    _assert_trees_equal(back["params"], variables["params"])
    _assert_trees_equal(back["batch_stats"], variables["batch_stats"])


@pytest.mark.parametrize("source", ["dir", "file"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_transformer_matches_jax_and_round_trips(
        tmp_path, monkeypatch, capsys, source, dtype):
    """--mode export of a transformer whose weights came from
    ``transformer_from_flax``: JAX's ``export_transformer_state`` bitwise
    (no ``transformer.mask``), and back through
    ``convert_transformer_state`` to the flax params bitwise."""
    monkeypatch.chdir(tmp_path)
    t_raw = dict(T_TINY, compute_dtype=dtype)
    jcfg = JTransformerConfig(**t_raw)
    params = _transformer_params(jcfg)
    ck = _save_source(tmp_path, transformer_from_flax(
        params, TransformerConfig(**t_raw)), source)
    path = _write_config(tmp_path, "export.json", {
        "train": {"mode": "export"}, "transformer": t_raw,
        "transformer_checkpoint": ck})
    assert main(["--config", path, "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == "exported.pt"
    got = torch.load(tmp_path / "exported.pt", weights_only=True)
    assert "transformer.mask" not in got
    _assert_bitwise(got, jexport.export_transformer_state(
        {"params": params}, jcfg))
    back = jimport.convert_transformer_state(
        {k: v.numpy() for k, v in got.items()}, jcfg)
    _assert_trees_equal(back["params"], params)


def test_export_without_checkpoint_has_the_reference_layout(tmp_path):
    """Seeded random weights (no checkpoint named): JAX's key set, fp32;
    a bf16 serving model's weights come out as their fp32 values; a config
    with neither section is refused."""
    from mas_tpu_torch.utils.config import ConfigError

    model_raw = dict(SEG_TINY, codebook=CB_TINY, compute_dtype="bfloat16")
    out = str(tmp_path / "vq.pt")
    path = _write_config(tmp_path, "export.json", {
        "train": {"mode": "export", "seed": 3}, "model": model_raw,
        "output": out})
    assert main(["--config", path, "--device", "cpu"]) == 0
    got = torch.load(out, weights_only=True)
    jcfg = JVQModelConfig(**{**model_raw, "codebook": JCodebookConfig(
        **CB_TINY)})
    want = jexport.export_vqbase_state(_vq_variables(jcfg), jcfg)
    assert sorted(got) == sorted(want)
    assert all(got[k].dtype == torch.from_numpy(np.array(v)).dtype
               and got[k].shape == v.shape for k, v in want.items())
    serving = VQModel(VQModelConfig.from_dict(model_raw)).eval()
    serving.load_state_dict(got)
    exported = export_state(serving)
    w = "encoder.model.0.weight"
    assert serving.state_dict()[w].dtype == torch.bfloat16
    assert exported[w].dtype == torch.float32
    assert torch.equal(exported[w], got[w].bfloat16().float())
    path = _write_config(tmp_path, "none.json", {"train": {"mode": "export"}})
    with pytest.raises(ConfigError, match="'transformer' or 'model'"):
        main(["--config", path, "--device", "cpu"])


@pytest.mark.parametrize("name", ["eval_256", "show_256", "export_vq"])
def test_shipped_configs_load_unchanged(name):
    with open(os.path.join(REPO, "configs", f"{name}.json")) as f:
        raw = json.load(f)
    train = dict(raw["train"], mode="pretrain_segmentation")
    TrainConfig.from_dict(train)
    model = VQModelConfig.from_dict(raw["model"])
    assert (model.in_channels, model.resolution,
            model.codebook.codebook_size) == (159, 256, 1024)


# --- C6: a checkpoint dir named as a checkpoint --------------------------------

def test_load_reference_pt_reads_the_latest_step_of_a_dir(tmp_path):
    state = {"w": torch.arange(3.0)}
    ck = _save_source(tmp_path, state, "dir")
    got = load_reference_pt(ck)
    assert list(got) == ["w"] and torch.equal(got["w"], state["w"])
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="jax"):
        load_reference_pt(str(tmp_path / "orbax"))


def test_sample_from_a_trained_dir_equals_the_step_file(tmp_path,
                                                        monkeypatch, capsys):
    """--mode train_transformer, then --mode sample with
    transformer_checkpoint naming its dir: the image equals the sample
    from the latest step file named by its full path."""
    from test_torch_port_transformer_train import _cli_config

    monkeypatch.chdir(tmp_path)
    assert main(["--config", _cli_config(tmp_path, 2, False),
                 "--device", "cpu"]) == 0
    ck = str(tmp_path / "ck")
    images = []
    for name, source in (("dir", ck),
                         ("file", checkpoint.checkpoint_path(ck, 2))):
        out = str(tmp_path / f"{name}.png")
        path = _write_config(tmp_path, f"sample_{name}.json", {
            "train": {"mode": "sample", "batch_size": 2, "seed": 0},
            "transformer": T_TINY, "model": VQ_SLICE,
            "transformer_checkpoint": source, "top_k": 8, "output": out,
            "captions": ["a dog running on a beach", "a red house"]})
        assert main(["--config", path, "--device", "cpu"]) == 0
        images.append(np.asarray(Image.open(out)))
    assert images[0].ndim == 3 and images[0].std() > 0
    np.testing.assert_array_equal(images[0], images[1])


# --- C7: python -m mas_tpu_torch ----------------------------------------------

def test_importing_main_runs_nothing(monkeypatch):
    import importlib

    import mas_tpu_torch.cli as cli

    calls = []
    monkeypatch.setattr(cli, "main", lambda *a, **k: calls.append(a) or 0)
    monkeypatch.setattr(cli, "run", lambda *a, **k: calls.append(a) or 0,
                        raising=False)
    monkeypatch.delitem(sys.modules, "mas_tpu_torch.__main__", raising=False)
    importlib.import_module("mas_tpu_torch.__main__")
    assert calls == []


def test_failing_run_appends_to_error_log(tmp_path):
    """An unknown mode: python -m mas_tpu_torch exits non-zero and the
    traceback lands in ./error.log, appended on a second failure."""
    path = _write_config(tmp_path, "cfg.json", {"train": {"mode": "bogus"}})
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for n in (1, 2):
        proc = subprocess.run(
            [sys.executable, "-m", "mas_tpu_torch", "--config", path,
             "--device", "cpu"], cwd=tmp_path, env=env, capture_output=True,
            text=True, timeout=300)
        assert proc.returncode != 0
        assert "unknown mode 'bogus'" in proc.stderr
        log = (tmp_path / "error.log").read_text()
        assert log.count("Traceback") == n
        assert "ConfigError: unknown mode 'bogus'" in log


def test_eval_show_export_modules_leave_jax_out():
    """The new modules, ``python -m``'s entry and the smoke import neither
    jax, flax, mas_tpu nor triton."""
    code = ("import sys, mas_tpu_torch.eval, mas_tpu_torch.utils.export, "
            "mas_tpu_torch.utils.logging, mas_tpu_torch.__main__, "
            "chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'mas_tpu', 'triton')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
