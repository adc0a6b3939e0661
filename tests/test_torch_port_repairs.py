"""Faults of the port against the JAX package, repaired, on CPU.

  * ``--mode sample`` builds a ``TrainConfig`` from the whole ``train``
    section, as ``mas_tpu/cli.py`` does, so a config whose train section
    holds training keys samples in both packages;
  * a training mode whose config lacks ``model`` / ``transformer`` takes
    the JAX package's defaults (``vq_seg_config()``, ``TransformerConfig()``);
  * attention at head dims other than 64 and any T: B1's and B6's twins,
    and the route the CUDA wrappers take (zero-pad the head dim to 64 or
    128, scale by the true d's 1/sqrt(d), drop the extra columns), against
    the JAX package at d 32 and 128 and at T 100 (no multiple of a tile)
    and 128: fp32 atol 1e-5.
"""

import dataclasses
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mas_tpu.ops.attention import flash_attention, prefix_causal_attention_jnp
from mas_tpu.utils import config as jconfig

from mas_tpu_torch.ops import attention
from mas_tpu_torch.utils import config as pconfig

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_models import T_TINY  # noqa: E402
from test_torch_port_pipeline import VQ_SLICE  # noqa: E402

TRAIN_KEYS = {"mode": "sample", "batch_size": 2, "seed": 3,
              "total_steps": 1000, "log_period": 10, "save_period": 500,
              "checkpoint_dir": "ck", "uncond_p": 0.2, "start_uncond": 5,
              "optimizer": {"lr": 1e-4, "beta1": 0.9, "accumulate_grad": 2}}


def test_cli_sample_takes_a_train_section_with_training_keys(
        tmp_path, monkeypatch):
    """C1: both packages build their TrainConfig from this section (mode
    mapped to the first training mode) and the port samples from it,
    reading batch_size and seed from the config object."""
    from mas_tpu_torch import cli

    jcfg = jconfig.TrainConfig.from_dict(
        dict(TRAIN_KEYS, mode="pretrain_segmentation"))
    out = tmp_path / "grid.png"
    raw = {"train": TRAIN_KEYS,
           "transformer": dict(T_TINY, kv_cache_dtype="int8"),
           "model": VQ_SLICE, "top_k": 4, "output": str(out)}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(raw))
    seen = {}
    real = cli.prompt_tokens

    def spy(raw_, cfg, batch_size):
        seen["batch_size"] = batch_size
        return real(raw_, cfg, batch_size)

    monkeypatch.setattr(cli, "prompt_tokens", spy)
    assert cli.main(["--config", str(path), "--mode", "sample",
                     "--device", "cpu"]) == 0
    assert out.is_file() and out.stat().st_size > 0
    assert seen["batch_size"] == jcfg.batch_size == 2


def _capture(monkeypatch, name):
    """Replace train.loop.<name> with a recorder of its arguments."""
    from mas_tpu_torch.train import loop

    seen = {}

    def run(*args, **kwargs):
        seen["args"] = args
        return type("State", (), {"step": 0})()

    monkeypatch.setattr(loop, name, run)
    return seen


def test_cli_seg_training_without_model_takes_vq_seg_config(
        tmp_path, monkeypatch):
    """C2: no ``model`` section -> vq_seg_config(), the JAX package's
    values field by field."""
    from mas_tpu_torch.cli import main

    seen = _capture(monkeypatch, "run_pretrain_segmentation")
    path = tmp_path / "seg.json"
    path.write_text(json.dumps({"train": {"mode": "pretrain_segmentation",
                                          "batch_size": 1}}))
    assert main(["--config", str(path), "--device", "cpu"]) == 0
    model_cfg = seen["args"][1]
    assert model_cfg == pconfig.vq_seg_config()
    assert (dataclasses.asdict(model_cfg)
            == dataclasses.asdict(jconfig.vq_seg_config()))


def test_cli_transformer_training_without_section_takes_defaults(
        tmp_path, monkeypatch):
    """C2: no ``transformer`` section -> TransformerConfig(), equal to the
    JAX package's default on every field the port declares."""
    from mas_tpu_torch.cli import main

    seen = _capture(monkeypatch, "run_train_transformer")
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"train": {"mode": "train_transformer",
                                          "batch_size": 1}}))
    assert main(["--config", str(path), "--device", "cpu"]) == 0
    model_cfg = seen["args"][1]
    assert model_cfg == pconfig.TransformerConfig()
    jdefault = dataclasses.asdict(jconfig.TransformerConfig())
    for key, value in dataclasses.asdict(model_cfg).items():
        assert jdefault[key] == value, key


def test_vq_img_config_matches_jax():
    assert (dataclasses.asdict(pconfig.vq_img_config())
            == dataclasses.asdict(jconfig.vq_img_config()))
    assert (pconfig.vq_seg_config(resolution=128).resolution
            == jconfig.vq_seg_config(resolution=128).resolution)


def _qkv(d, t, seed):
    r = np.random.default_rng(seed)
    return [r.standard_normal((1, 2, t, d)).astype(np.float32)
            for _ in range(4)]


def _jax_fwd_bwd(q, k, v, do, prefix):
    """The JAX package's attention and its gradient: the Pallas flash
    kernels in interpret mode where T tiles into 64, the jnp path else."""
    t = q.shape[2]
    if t % 64 == 0:
        fn = lambda q_, k_, v_: flash_attention(q_, k_, v_, prefix, 64, 64,
                                                interpret=True)
    else:
        fn = lambda q_, k_, v_: prefix_causal_attention_jnp(q_, k_, v_,
                                                            prefix)
    out, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("t,prefix", [(100, 40), (128, 0), (128, 64)])
@pytest.mark.parametrize("d", [32, 128])
def test_attention_other_head_dims_twins_and_padded_route_match_jax(d, t,
                                                                   prefix):
    """C3: the twins at head dim d, and the padded route (the twin on q, k,
    v, out, dO zero-padded to the kernels' width with the true d's scale,
    extra columns dropped), against JAX; the padded lse is the twin's."""
    q, k, v, do = _qkv(d, t, d + t + prefix)
    ref_out, ref_grads = _jax_fwd_bwd(q, k, v, do, prefix)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))

    out, lse = attention.flash_attention(tq, tk, tv, prefix)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=1e-5)
    for g, want in zip(attention.prefix_causal_attention_bwd_plain(
            tq, tk, tv, out, lse, tdo, prefix), ref_grads):
        np.testing.assert_allclose(g.numpy(), want, atol=1e-5)

    width = attention.kernel_head_dim(d)
    assert width == (64 if d <= 64 else 128)
    pq, pk, pv, pdo = (attention.pad_head_dim(x, width)
                       for x in (tq, tk, tv, tdo))
    p_out, p_lse = attention.prefix_causal_attention_plain(
        pq, pk, pv, prefix, scale=attention.q_scale(d, tq.dtype))
    assert not p_out[..., d:].any()
    np.testing.assert_allclose(p_out[..., :d].numpy(), ref_out, atol=1e-5)
    np.testing.assert_allclose(p_lse.numpy(), lse.numpy(), atol=1e-5)
    grads = attention.prefix_causal_attention_bwd_plain(
        pq, pk, pv, p_out, p_lse, pdo, prefix, scale=1.0 / math.sqrt(d))
    for g, want in zip(grads, ref_grads):
        np.testing.assert_allclose(g[..., :d].numpy(), want, atol=1e-5)


@pytest.mark.parametrize("d", [32, 100])
def test_flash_attention_function_other_head_dims_and_ragged_t(d):
    """FlashAttentionFunction (the twins on CPU) at head dims 32 and 100
    and T 100 under autograd: the gradient of the fused qkv equals autograd
    through the plain forward, fp32 atol 1e-5."""
    r = np.random.default_rng(d)
    qkv = torch.from_numpy(r.standard_normal((1, 100, 3, 2, d)).astype(
        np.float32)).requires_grad_()
    g = torch.from_numpy(r.standard_normal((1, 2, 100, d)).astype(np.float32))
    out = attention.FlashAttentionFunction.apply(qkv, 30)
    got, = torch.autograd.grad(out, qkv, g)
    ref, _ = attention.prefix_causal_attention_plain(
        *attention.split_qkv(qkv), 30)
    want, = torch.autograd.grad(ref, qkv, g)
    assert got.shape == qkv.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_attention_head_dim_above_128_raises():
    """Head dims above 128 take the D = 256 kernels (129 and 256 alike),
    and above 256 the least multiple of 256 in column passes; only a head
    dim below 1 raises."""
    assert attention.kernel_head_dim(128) == 128
    assert attention.kernel_head_dim(129) == 256
    assert attention.kernel_head_dim(256) == 256
    assert attention.kernel_head_dim(257) == 512
    assert attention.kernel_head_dim(768) == 768
    with pytest.raises(ValueError, match="head_dim"):
        attention.kernel_head_dim(0)
