"""The port's VQ evaluation (``mas_tpu_torch/eval.py`` and ``--mode eval``)
against the JAX package's (``mas_tpu/eval.py``), on CPU.

Inputs come from numpy seeds; weights cross with ``vq_from_flax`` /
``lpips_from_flax``; the VQ models are tiny (channels (32, 32, 64), 32^2,
K 64 for seg, K 16 for RGB), LPIPS keeps the full VGG16 widths at 32^2.
Tolerances: fp32 throughout, l1 / mse rel 1e-5, psnr abs 1e-4, lpips and
the pooled VGG16 features rel 1e-4, codebook stats of the same tokens rel
1e-6, the float64 FID sums rel 1e-9; a whole evaluation rel 1e-4 with the
tokens equal.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mas_tpu import eval as jeval
from mas_tpu.losses.lpips import LPIPS as JLPIPS
from mas_tpu.models.vqvae import VQModel as JVQModel
from mas_tpu.utils.config import CodebookConfig as JCodebookConfig
from mas_tpu.utils.config import VQModelConfig as JVQModelConfig

from mas_tpu_torch import eval as teval
from mas_tpu_torch.data.dataset import (SyntheticImgBatches,
                                        SyntheticSegBatches)
from mas_tpu_torch.losses.lpips import LPIPS
from mas_tpu_torch.models.vqvae import VQModel
from mas_tpu_torch.utils.config import VQModelConfig
from mas_tpu_torch.utils.weights import lpips_from_flax, vq_from_flax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_vq import CB_TINY, SEG_TINY  # noqa: E402

IMG_TINY = dict(in_channels=3, out_channels=3, resolution=32,
                channels=(32, 32, 64), attn_resolutions=(8,), z_channels=32,
                embed_dim=32)
CB_IMG = dict(codebook_size=16, codebook_dim=32)
JAX_KEYS = {"l1", "mse", "psnr", "perplexity", "entropy", "used_fraction",
            "max_usage"}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _lpips_pair():
    """(JAX LPIPS params with lin weights other than ones, the port's
    LPIPS on them)."""
    x = jnp.zeros((1, 32, 32, 3))
    params = _np(JLPIPS().init(jax.random.PRNGKey(1), x, x))["params"]
    r = np.random.default_rng(4)
    for i in range(5):
        params[f"lin{i}"] = r.uniform(0.5, 1.5, params[f"lin{i}"].shape
                                      ).astype(np.float32)
    model = LPIPS()
    model.load_state_dict(lpips_from_flax(params), strict=True)
    return params, model.eval().requires_grad_(False)


def _images(seed, shape=(2, 32, 32, 3)):
    r = np.random.default_rng(seed)
    return tuple(r.random(shape, np.float32) for _ in range(2))


def test_recon_metrics_match_jax():
    params, lp = _lpips_pair()
    x, y = _images(0)
    jlp = JLPIPS()
    want = jeval.recon_metrics(
        jnp.asarray(x), jnp.asarray(y),
        lambda a, b: jlp.apply({"params": params}, a, b))
    with torch.no_grad():
        got = teval.recon_metrics(torch.from_numpy(x), torch.from_numpy(y),
                                  lp)
    assert set(got) == set(want) == {"l1", "mse", "psnr", "lpips"}
    for k in ("l1", "mse"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)
    np.testing.assert_allclose(float(got["psnr"]), float(want["psnr"]),
                               atol=1e-4)
    np.testing.assert_allclose(float(got["lpips"]), float(want["lpips"]),
                               rtol=1e-4)
    same = teval.recon_metrics(torch.from_numpy(x), torch.from_numpy(x))
    assert "lpips" not in same and float(same["psnr"]) > 100


@pytest.mark.parametrize("k,spread", [(64, 16), (1024, 1024), (16, 1)])
def test_codebook_stats_match_jax(k, spread):
    idx = np.random.default_rng(k).integers(0, spread, (2, 16, 16))
    want = jeval.codebook_stats(jnp.asarray(idx, jnp.int32), k)
    got = teval.codebook_stats(torch.from_numpy(idx).int(), k)
    assert set(got) == set(want)
    for key, v in want.items():
        np.testing.assert_allclose(float(got[key]), float(v), rtol=1e-6,
                                   err_msg=key)


def test_fid_and_accumulator_match_jax():
    r = np.random.default_rng(2)
    real = r.standard_normal((40, 2, 2, 3))
    fake = r.standard_normal((40, 2, 2, 3)) * 1.2 + 0.3
    flat = lambda imgs: np.asarray(imgs).reshape(len(imgs), -1)  # noqa: E731
    accs = {}
    for name, mod in (("jax", jeval), ("port", teval)):
        a, b = mod.FIDAccumulator(flat), mod.FIDAccumulator(flat)
        for i in range(0, 40, 8):
            a.update(real[i:i + 8])
            b.update(fake[i:i + 8])
        accs[name] = (a, b)
    (ja, jb), (ta, tb) = accs["jax"], accs["port"]
    for j, t in ((ja, ta), (jb, tb)):
        for want, got in zip(j.stats(), t.stats()):
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tb.fid(ta), jb.fid(ja), rtol=1e-9)
    mu1, s1 = accs["port"][0].stats()
    mu2, s2 = accs["port"][1].stats()
    np.testing.assert_allclose(teval.fid_from_features(mu1, s1, mu2, s2),
                               jeval.fid_from_features(mu1, s1, mu2, s2),
                               rtol=1e-9)
    with pytest.raises(ValueError, match="more than one"):
        teval.FIDAccumulator(flat).stats()


def test_fid_offsets_a_singular_product_whose_root_is_not_finite(
        monkeypatch):
    """8 samples of 64 features, 10 never firing: where scipy's square
    root of the singular product comes back non-finite, both covariances
    get FID_EPS on the diagonal for the root (pytorch-fid), so the distance
    stays finite and close to the exact one."""
    import scipy.linalg

    r = np.random.default_rng(3)
    feats = [np.abs(r.standard_normal((8, 64))) for _ in range(2)]
    for f in feats:
        f[:, :10] = 0.0
    (mu1, s1), (mu2, s2) = ((f.mean(0), np.cov(f, rowvar=False))
                            for f in feats)
    exact = teval.fid_from_features(mu1, s1, mu2, s2)
    root, calls = scipy.linalg.sqrtm, []

    def broken(a):
        calls.append(a)
        return np.full_like(a, np.nan) if len(calls) == 1 else root(a)

    monkeypatch.setattr(scipy.linalg, "sqrtm", broken)
    got = teval.fid_from_features(mu1, s1, mu2, s2)
    offset = np.eye(64) * teval.FID_EPS
    np.testing.assert_array_equal(calls[1], (s1 + offset) @ (s2 + offset))
    assert np.isfinite(got) and abs(got - exact) < 1e-3 * exact


def test_lpips_feature_fn_matches_jax():
    params, lp = _lpips_pair()
    x, _ = _images(1, (3, 32, 32, 3))
    want = jeval.lpips_feature_fn(JLPIPS(), {"params": params})(x)
    got = teval.lpips_feature_fn(lp)(x)
    assert got.shape == (3, 64 + 128 + 256 + 512 + 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)


def _vq_pair(model_kw, cb, seed=0):
    """(JAX VQModel, numpy variables with a N(0, 1) codebook, the port's
    VQModel on them, in eval mode)."""
    jcfg = JVQModelConfig(**model_kw, codebook=JCodebookConfig(**cb))
    jmodel = JVQModel(jcfg)
    r = model_kw["resolution"]
    variables = _np(jmodel.init(jax.random.PRNGKey(seed),
                                jnp.zeros((1, r, r, model_kw["in_channels"]))))
    variables["params"]["codebook_embedding"] = np.random.default_rng(
        seed + 7).standard_normal((cb["codebook_size"], cb["codebook_dim"])
                                  ).astype(np.float32)
    model = VQModel(VQModelConfig(**model_kw, codebook=cb)).eval()
    model.load_state_dict(vq_from_flax(variables, model.cfg), strict=True)
    return jmodel, variables, model


@pytest.mark.parametrize("kind", ["seg", "rgb"])
def test_evaluate_vq_model_matches_jax(kind):
    """Two batches of the synthetic data (the same numpy draws in both
    packages); the RGB model with LPIPS.  Same keys as JAX, every metric
    rel 1e-4, and the tokens of each batch equal."""
    from mas_tpu.data.dataset import SyntheticImgBatches as JImg
    from mas_tpu.data.dataset import SyntheticSegBatches as JSeg

    if kind == "seg":
        jmodel, variables, model = _vq_pair(SEG_TINY, CB_TINY, seed=1)
        jsource, source = iter(JSeg(2, 32, 3)), iter(SyntheticSegBatches(
            2, 32, 3))
        jlpips = lpips = None
    else:
        jmodel, variables, model = _vq_pair(IMG_TINY, CB_IMG, seed=2)
        jsource, source = iter(JImg(2, 32, seed=3)), iter(
            SyntheticImgBatches(2, 32, seed=3))
        params, lpips = _lpips_pair()
        jlp = JLPIPS()
        jlpips = lambda a, b: jlp.apply({"params": params}, a, b)  # noqa
    jbatches = [next(jsource) for _ in range(2)]
    batches = [next(source) for _ in range(2)]
    want = jeval.evaluate_vq_model(jmodel, variables, iter(jbatches),
                                   n_batches=2, lpips_apply=jlpips)
    got = teval.evaluate_vq_model(model, iter(batches), n_batches=2,
                                  lpips_apply=lpips)
    assert set(got) == set(want) == JAX_KEYS | ({"lpips"} if lpips else set())
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)
    key = "mask" if kind == "seg" else "image"
    for jb, b in zip(jbatches, batches):
        np.testing.assert_array_equal(b[key], jb[key])
        jtok = jmodel.apply(variables, jnp.asarray(jb[key]),
                            method=JVQModel.encode_tokens)
        _, tok = teval.eval_step(model, torch.from_numpy(b[key]))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_eval_step_equals_forward_and_encode_tokens():
    """The one-encode step gives the eval forward's recon and
    ``encode_tokens``' tokens bitwise."""
    _, _, model = _vq_pair(SEG_TINY, CB_TINY, seed=3)
    x = torch.from_numpy(next(iter(SyntheticSegBatches(2, 32, 5)))["mask"])
    recon, tok = teval.eval_step(model, x)
    with torch.no_grad():
        ref, _ = model(x)
        ref_tok = model.encode_tokens(x)
    assert torch.equal(recon, ref) and torch.equal(tok, ref_tok)


def _train_seg_dir(tmp_path, steps=2):
    """Train the tiny seg model with the port CLI; returns the config and
    the checkpoint dir."""
    from test_torch_port_train import _cli_config

    from mas_tpu_torch.cli import main

    path = _cli_config(tmp_path, steps, False)
    assert main(["--config", path, "--device", "cpu"]) == 0
    return json.loads(open(path).read()), str(tmp_path / "ck")


def test_cli_eval_on_a_trained_checkpoint_dir(tmp_path, monkeypatch, capsys):
    """--mode eval with train.resume and train.checkpoint_dir naming a dir
    that --mode pretrain_segmentation wrote: one JSON line with JAX's
    keys, equal to evaluate_vq_model on the latest step file's weights."""
    from mas_tpu_torch.cli import main
    from mas_tpu_torch.utils import checkpoint

    monkeypatch.chdir(tmp_path)
    raw, ck = _train_seg_dir(tmp_path)
    raw["train"].update(mode="eval", resume=True, checkpoint_dir=ck)
    raw["n_eval_batches"] = 2
    path = tmp_path / "eval.json"
    path.write_text(json.dumps(raw))
    capsys.readouterr()
    assert main(["--config", str(path), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    metrics = json.loads(lines[0])
    assert set(metrics) == JAX_KEYS
    assert all(np.isfinite(v) for v in metrics.values())
    model = VQModel(VQModelConfig.from_dict(raw["model"])).eval()
    payload = torch.load(checkpoint.checkpoint_path(ck, 2),
                         weights_only=True)
    model.load_state_dict(payload["model"], strict=True)
    want = teval.evaluate_vq_model(model, iter(SyntheticSegBatches(2, 32)),
                                   n_batches=2)
    assert metrics == want
