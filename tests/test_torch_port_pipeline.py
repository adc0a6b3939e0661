"""The port's serving slice end to end vs the JAX package, on CPU.

Greedy sampling (top_k = 1) with guidance 3.0 over an int8 cache must give
the JAX sampler's tokens exactly; the images must match JAX's
``sample_images`` to 1e-4 (fp32).  Also: greedy sampling over a float
cache, the CLI writes an image from a tiny JSON config, the package
imports without jax, and the TPU-only knobs raise instead of being
ignored.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mas_tpu.models import sampler as jsampler

from mas_tpu_torch.models.sampler import sample_images, sample_tokens
from mas_tpu_torch.utils.config import TransformerConfig, VQModelConfig

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_models import T_TINY, _t_pair, _tokens  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VQ_SLICE = dict(channels=(32, 32, 64), resolution=8, attn_resolutions=(4,),
                z_channels=32, embed_dim=16, num_res_blocks=1,
                codebook=dict(codebook_size=96, codebook_dim=16,
                              reservoir_size=96))


def _vq_slice_pair(seed=0):
    from mas_tpu.models.vqvae import VQModel as JVQModel
    from mas_tpu.utils.config import CodebookConfig as JCodebookConfig
    from mas_tpu.utils.config import VQModelConfig as JVQModelConfig

    from mas_tpu_torch.models.vqvae import VQModel
    from mas_tpu_torch.utils.weights import vq_from_flax

    jcfg = JVQModelConfig(**{**VQ_SLICE, "codebook": JCodebookConfig(
        **VQ_SLICE["codebook"])})
    jmodel = JVQModel(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, 3)))
    model = VQModel(VQModelConfig(**VQ_SLICE)).eval()
    model.load_state_dict(
        vq_from_flax(jax.tree.map(np.asarray, variables), model.cfg),
        strict=True)
    return jmodel, variables, model


@pytest.mark.parametrize("cache", ["int8", "int4"])
def test_greedy_sample_images_match_jax(cache):
    jt, tvars, pt = _t_pair(seed=11, kv_cache_dtype=cache)
    jv, vvars, pv = _vq_slice_pair(seed=12)
    text, seg, _ = _tokens(pt.cfg, b=2, seed=13)
    j = lambda a: jnp.asarray(a, jnp.int32)
    ref_tok = jsampler.sample_tokens(jt, tvars, j(text), j(seg),
                                     jax.random.PRNGKey(0),
                                     guidance_scale=3.0, top_k=1)
    gen = torch.Generator().manual_seed(0)
    tok = sample_tokens(pt, torch.from_numpy(text), torch.from_numpy(seg),
                        gen, guidance_scale=3.0, top_k=1)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    if cache == "int4":
        return
    ref_img = jsampler.sample_images(jt, tvars, jv, vvars, j(text), j(seg),
                                     jax.random.PRNGKey(0),
                                     guidance_scale=3.0, top_k=1)
    img = sample_images(pt, pv, torch.from_numpy(text),
                        torch.from_numpy(seg), gen, guidance_scale=3.0,
                        top_k=1)
    assert img.shape == (2, 8, 8, 3) and img.dtype == torch.float32
    np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), atol=1e-4)


def test_top_k_sampling_stays_in_top_k():
    from mas_tpu_torch.models.sampler import _sample_logits

    logits = torch.randn(64, 96, generator=torch.Generator().manual_seed(1))
    top = torch.topk(logits, 5).indices
    tok = _sample_logits(logits, torch.Generator().manual_seed(2), 0.7, 5)
    assert bool((top == tok[:, None]).any(dim=1).all())
    again = _sample_logits(logits, torch.Generator().manual_seed(2), 0.7, 5)
    assert torch.equal(tok, again)


def test_cli_writes_sample_grid(tmp_path):
    out = tmp_path / "grid.png"
    cfg = {"train": {"mode": "sample", "batch_size": 2, "seed": 0},
           "transformer": dict(T_TINY, kv_cache_dtype="int4",
                               compute_dtype="bfloat16"),
           "model": dict(VQ_SLICE, compute_dtype="bfloat16"),
           "guidance_scale": 3.0, "top_k": 8, "output": str(out),
           "captions": ["a dog running on a beach", "a red house"]}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    proc = subprocess.run(
        [sys.executable, "-m", "mas_tpu_torch.cli", "--config", str(path),
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert out.is_file() and out.stat().st_size > 0
    assert proc.stdout.strip().endswith(str(out))


def test_cli_refuses_unported_modes(tmp_path):
    """Every mode of ``mas_tpu/cli.py`` is ported: an unknown mode is a
    ConfigError, and ``preprocess_dataset`` without its ``shards`` fails
    as the JAX package's does."""
    from mas_tpu_torch.cli import main
    from mas_tpu_torch.utils.config import ConfigError

    path = tmp_path / "cfg.json"
    for mode, error in (("preprocess_dataset", KeyError),
                        ("distill", ConfigError)):
        path.write_text(json.dumps({"train": {"mode": mode}}))
        with pytest.raises(error):
            main(["--config", str(path), "--device", "cpu"])


def test_tokenizer_matches_jax():
    from mas_tpu.data.tokenizer import HashWordTokenizer as JTokenizer

    from mas_tpu_torch.data.tokenizer import HashWordTokenizer

    captions = ["a dog running on a beach", "A Red HOUSE in snow", "",
                " ".join(f"w{i}" for i in range(20))]
    got = HashWordTokenizer(vocab_size=120, text_length=8)(captions)
    assert got.dtype == np.int32 and got.shape == (4, 8)
    np.testing.assert_array_equal(
        got, JTokenizer(vocab_size=120, text_length=8)(captions))


@pytest.mark.parametrize("n,nrow", [(4, 8), (5, 2)])
def test_make_grid_matches_jax(n, nrow):
    from mas_tpu.utils.logging import make_grid as jmake_grid

    from mas_tpu_torch.utils.logging import make_grid

    imgs = np.random.default_rng(n).uniform(-0.2, 1.2, (n, 6, 5, 3))
    np.testing.assert_array_equal(make_grid(imgs, nrow=nrow),
                                  jmake_grid(imgs, nrow=nrow))


def test_sample_config_loads_unchanged():
    with open(os.path.join(REPO, "configs", "sample_256.json")) as f:
        raw = json.load(f)
    t = TransformerConfig.from_dict(raw["transformer"])
    v = VQModelConfig.from_dict(raw["model"])
    assert (t.num_layers, t.hidden_dim, t.head_dim, t.prefix_length,
            t.total_length) == (24, 1024, 64, 384, 640)
    assert t.kv_cache_dtype == "int4" and t.compute_dtype == "bfloat16"
    assert v.channels == (128, 128, 128, 256, 512, 512)
    assert v.latent_resolution == 16 and v.codebook.codebook_size == 8192


def test_import_leaves_jax_out():
    code = ("import sys, mas_tpu_torch, mas_tpu_torch.cli, "
            "mas_tpu_torch.models.sampler, mas_tpu_torch.ops.gn_swish, "
            "mas_tpu_torch.ops.decode_cache, mas_tpu_torch.utils.weights, "
            "mas_tpu_torch.breakdown, mas_tpu_torch.train.loop, "
            "mas_tpu_torch.ops.vq, mas_tpu_torch.utils.checkpoint, "
            "mas_tpu_torch.ops.decode_attention, "
            "mas_tpu_torch.ops.ln_producer; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'mas_tpu', 'triton')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("knob", [
    dict(decode_ring_tail=True), dict(decode_length_buckets=2),
    dict(decode_q_rows=4),
    dict(decode_length_buckets=2, num_kv_heads=1),
    dict(decode_ring_tail=True, rudalle_relax=True),
    dict(decode_q_rows=4, cogview_layernorm_prescale=True),
    dict(decode_length_buckets=2, ln_matmul_fold=True),
    dict(decode_q_rows=2, scan_layers=True),
    dict(decode_length_buckets=2, ln_matmul_fold=True,
         layernorm_impl="pallas"),
    dict(decode_q_rows=4, kv_scale_dtype="bfloat16", kv_cache_dtype="int4")])
def test_tpu_only_knobs_raise(knob):
    """The TPU ablations raise, also beside the transformer variants that
    the port now takes (grouped-query attention, rudalle_relax, the
    prescale, the fold, scan_layers trees, bf16 cache scales)."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TransformerConfig(**T_TINY, **knob)


def test_lane_aliased_is_accepted_and_float_cache_raises_at_decode():
    """Once a refusal test (the float cache had no kernel): now lane_aliased
    is accepted where the JAX package accepts it (total_length a multiple
    of 128), and sampling over a float cache gives JAX's greedy tokens."""
    TransformerConfig(**dict(T_TINY, text_length=96, text_vocab_size=128),
                      kv_cache_layout="lane_aliased", kv_cache_dtype="int8")
    jt, tvars, model = _t_pair(seed=1)     # kv_cache_dtype='compute'
    text, seg, _ = _tokens(model.cfg)
    ref = jsampler.sample_tokens(jt, tvars, jnp.asarray(text, jnp.int32),
                                 jnp.asarray(seg, jnp.int32),
                                 jax.random.PRNGKey(0), top_k=1)
    tok = sample_tokens(model, torch.from_numpy(text), torch.from_numpy(seg),
                        torch.Generator(), top_k=1)
    assert tok.shape == (2, model.cfg.image_length)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref))


def test_cache_segment_raises():
    _, _, model = _t_pair(seed=1, kv_cache_dtype="int8")
    text, seg, _ = _tokens(model.cfg)
    with pytest.raises(NotImplementedError, match="cache_segment"):
        sample_tokens(model, torch.from_numpy(text), torch.from_numpy(seg),
                      torch.Generator(), cache_segment=128)
