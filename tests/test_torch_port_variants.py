"""The transformer's variant architectures in the port vs the JAX package,
on CPU, with the same weights and the same numpy inputs: grouped-query
attention (``num_kv_heads``), bf16 cache scales (``kv_scale_dtype``),
``rudalle_relax`` with ``cogview_layernorm_prescale``, ``ln_matmul_fold``
and ``scan_layers`` trees; the config's refusals.  Gradients and the CLI:
``test_torch_port_variants_train.py``.

fp32 throughout, 2 layers, hidden 64, 4 heads (head dim 16).  On CPU every
kernel wrapper runs its plain twin, so these tests hold the algorithms,
layouts and weight bridge; ``chip_smoke.py`` holds the kernels against the
twins on the card.  Tolerances:
  * logits of the full sequence and of prefill, and decode logits over a
    float cache: atol 1e-4 (fp32 products summed in other orders);
  * decode logits over int8 caches 1e-3, over int4 caches (fp32 or bf16
    scales) 1e-2: a k/v value that differs in its last fp32 bit between
    the packages can land on the other side of a rounding boundary of the
    quantization grid, which moves it by a whole step (as
    ``test_torch_port_models.py``);
  * rudalle_relax: the port runs the fused form (q over sigma^2, v over
    its max, one masked softmax), JAX's CPU path the unfused one (scores
    over sigma twice, the midpoint shift, the -65504 mask): the same
    distribution, rounded in other places; its scores are q k / (sqrt(d)
    sigma^2), large at these random weights, so logits hold to atol 1e-3
    (gradients: atol 1e-4 + rtol 1e-3, in the training file);
  * the grouped plain twins of B2 and B9 against JAX's jnp reads: 1e-5;
  * bf16 scales: bitwise.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mas_tpu.models import transformer as jtransformer
from mas_tpu.models.transformer import MakeAScene as JMakeAScene
from mas_tpu.ops import quant as jquant
from mas_tpu.ops.decode_attention import decode_attention as jdecode_float
from mas_tpu.ops.decode_attention import transpose_cache
from mas_tpu.utils.config import ConfigError as JConfigError
from mas_tpu.utils.config import TransformerConfig as JTransformerConfig

from mas_tpu_torch.models import transformer as ptransformer
from mas_tpu_torch.models.transformer import MakeAScene
from mas_tpu_torch.ops import decode_attention, decode_cache, quant
from mas_tpu_torch.ops.decode_attention import FloatCache
from mas_tpu_torch.utils.config import ConfigError, TransformerConfig
from mas_tpu_torch.utils.weights import (transformer_from_flax,
                                         unstack_layer_params)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_models import _np_tree  # noqa: E402

V_TINY = dict(num_layers=2, hidden_dim=64, num_attn_heads=4,
              image_vocab_size=96, seg_vocab_size=32, text_vocab_size=72,
              image_tokens_per_dim=4, seg_tokens_per_dim=4, text_length=8)
RUDALLE = dict(rudalle_relax=True, cogview_layernorm_prescale=True)


def _pair(seed=0, fp32_params=False, **kw):
    """JAX MakeAScene + its variables, and the port's model with the same
    weights (through ``transformer_from_flax``)."""
    cfg = dict(V_TINY, **kw)
    jcfg = JTransformerConfig(**cfg)
    jmodel = JMakeAScene(jcfg)
    variables = jmodel.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, jcfg.text_length), jnp.int32),
        jnp.zeros((1, jcfg.seg_length), jnp.int32),
        jnp.zeros((1, jcfg.image_length), jnp.int32))
    model = MakeAScene(TransformerConfig(**cfg), fp32_params=fp32_params)
    model.load_state_dict(transformer_from_flax(_np_tree(variables),
                                                model.cfg), strict=True)
    return jmodel, variables, model.eval()


def _tokens(cfg, b=2, seed=1):
    r = np.random.default_rng(seed)
    text = r.integers(1, cfg.text_vocab_size - cfg.text_length,
                      (b, cfg.text_length))
    text[:, -3:] = 0                          # exercise the pad remap
    seg = r.integers(0, cfg.seg_vocab_size, (b, cfg.seg_length))
    img = r.integers(0, cfg.image_vocab_size, (b, cfg.image_length))
    return text, seg, img


def _j(a):
    return jnp.asarray(a, jnp.int32)


def _forward_pair(jmodel, variables, model, seed=1):
    text, seg, img = _tokens(model.cfg, seed=seed)
    ref = jmodel.apply(variables, _j(text), _j(seg), _j(img))
    ref0, _ = jmodel.apply(variables, _j(text), _j(seg),
                           method=JMakeAScene.prefill)
    t = torch.from_numpy
    with torch.no_grad():
        got = model(t(text), t(seg), t(img))
        got0, kvs = model.prefill(t(text), t(seg))
    return (got, ref), (got0, ref0), kvs


# --- grouped-query attention --------------------------------------------------

@pytest.mark.parametrize("kv_heads", [2, 1])
def test_gqa_forward_and_prefill_match_jax(kv_heads):
    jmodel, variables, model = _pair(seed=2, num_kv_heads=kv_heads)
    (got, ref), (got0, ref0), kvs = _forward_pair(jmodel, variables, model)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(got0.numpy(), np.asarray(ref0), atol=1e-4)
    qkv = model.transformer.layers[0].attn.qkv.weight
    assert qkv.shape == (64 + 2 * kv_heads * 16, 64)
    assert kvs[0][0].shape == (2, kv_heads, model.cfg.prefix_length, 16)


def _jax_caches(jcfg, jkv, cache):
    """The JAX sampler's caches (``mas_tpu/models/sampler.py:142-165``)
    seeded with the prefill's k/v: [B, kv_heads, hd, T]."""
    bb = jkv[0][0].shape[0]
    shape = (bb, jcfg.kv_heads, jcfg.head_dim, jcfg.total_length)
    dus = lambda full, part: jax.lax.dynamic_update_slice(
        full, part, (0, 0, 0, 0))
    if cache == "compute":
        full = jnp.zeros(shape, jkv[0][0].dtype)
        return tuple((dus(full, transpose_cache(k)),
                      dus(full, transpose_cache(v))) for k, v in jkv)
    qdt = jnp.int4 if jcfg.kv_cache_dtype == "int4" else jnp.int8
    sdt = (jnp.bfloat16 if jcfg.kv_scale_dtype == "bfloat16"
           else jnp.float32)
    q_full = jnp.zeros(shape, qdt)
    s_full = jnp.ones(shape[:2] + (1, shape[3]), sdt)

    def seed(kv):
        qc = jquant.quantize_kv(transpose_cache(kv), dtype=qdt,
                                scale_dtype=sdt)
        return jquant.QuantCache(dus(q_full, qc.q), dus(s_full, qc.scale))

    return tuple((seed(k), seed(v)) for k, v in jkv)


def _teacher_forced(jmodel, variables, model, atol, steps=8, seed=4):
    """Prefill + ``steps`` decode steps over the same forced tokens, with
    the batch doubled as guidance doubles it, in both packages; returns
    the port's caches."""
    cfg = model.cfg
    text, seg, img = _tokens(cfg, seed=seed)
    text = np.concatenate([text, np.zeros_like(text)])
    seg = np.concatenate([seg, seg])
    img = np.concatenate([img, img])
    ref0, jkv = jmodel.apply(variables, _j(text), _j(seg),
                             method=JMakeAScene.prefill)
    jcaches = _jax_caches(jmodel.cfg, jkv, cfg.kv_cache_dtype)
    step_fn = jax.jit(lambda v, tok, step, c: jmodel.apply(
        v, tok, step, c, method=JMakeAScene.decode_step))
    with torch.no_grad():
        got0, kvs = model.prefill(torch.from_numpy(text),
                                  torch.from_numpy(seg))
        caches = model.allocate_caches(kvs, text.shape[0])
        np.testing.assert_allclose(got0.numpy(), np.asarray(ref0),
                                   atol=1e-4 if atol < 1e-3 else atol)
        for step in range(steps):
            tok = img[:, step:step + 1]
            ref, jcaches = step_fn(variables, _j(tok), step, jcaches)
            got = model.decode_step(torch.from_numpy(tok), step, caches)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       atol=atol, err_msg=f"step {step}")
    return caches, jcaches


@pytest.mark.parametrize("kv_heads,cache,scales,atol", [
    (2, "compute", "float32", 1e-4), (2, "int8", "float32", 1e-3),
    (2, "int4", "float32", 1e-2), (2, "int4", "bfloat16", 1e-2),
    (1, "compute", "float32", 1e-4), (1, "int4", "bfloat16", 1e-2)])
def test_gqa_teacher_forced_decode_matches_jax(kv_heads, cache, scales,
                                               atol):
    jmodel, variables, model = _pair(seed=3, num_kv_heads=kv_heads,
                                     kv_cache_dtype=cache,
                                     kv_scale_dtype=scales)
    caches, jcaches = _teacher_forced(jmodel, variables, model, atol)
    k = caches[0].k
    if cache == "compute":
        assert k.data.shape[:2] == (4, kv_heads)
        return
    assert k.q.shape[1] == kv_heads and k.scale.dtype == (
        torch.bfloat16 if scales == "bfloat16" else torch.float32)
    upto = model.cfg.prefix_length + 8
    got = k.values()[:, :, :upto, :16].numpy()
    want = np.asarray(jcaches[0][0].q.astype(jnp.int8))[..., :upto]
    assert np.mean(got == want.transpose(0, 1, 3, 2)) > (
        0.999 if cache == "int8" else 0.99)


def _grouped_inputs(g, bits=None, seed=0, b=3, kv=2, t=24, d=16):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, kv * g, 1, d)).astype(np.float32)
    k, v = (r.standard_normal((b, kv, t, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("bits", [8, 4])
def test_grouped_b2_twin_matches_jax(g, bits):
    """The plain twin of B2 at g query rows per kv head against JAX's jnp
    read of the grouped q ([B, kv_heads, g, d] against [B, kv_heads, d,
    T] caches, ``mas_tpu/models/transformer.py:348``), on the same
    quantized caches, fp32 and bf16 scales."""
    q, k, v = _grouped_inputs(g, seed=g + bits)
    b, h, _, d = q.shape
    kv = k.shape[1]
    jdt = jnp.int4 if bits == 4 else jnp.int8
    for sdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jk, jv = (jquant.quantize_kv(jnp.asarray(x).transpose(0, 1, 3, 2),
                                     dtype=jdt, scale_dtype=sdt)
                  for x in (k, v))
        pk, pv = (quant.quantize_kv(torch.from_numpy(x), bits, tdt)
                  for x in (k, v))
        for index in (0, 5, 23):
            ref = jquant._decode_attention_int8_jnp(
                jnp.asarray(q).reshape(b, kv, g, d), jk, jv, index)
            got = quant.decode_attention_quant_plain(
                torch.from_numpy(q), pk, pv,
                torch.tensor([index], dtype=torch.int32))
            np.testing.assert_allclose(
                got.numpy(), np.asarray(ref).reshape(b, h, 1, d), atol=1e-5,
                err_msg=f"{sdt} index {index}")


@pytest.mark.parametrize("g", [1, 2, 4])
def test_grouped_b9_twin_matches_jax(g):
    """The plain twin of B9 at g query rows per kv head against JAX's
    ``decode_attention`` (jnp) of the grouped q, over a cache padded to
    32 values a position (d 16)."""
    q, k, v = _grouped_inputs(g, seed=10 + g)
    b, h, _, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    pk, pv = (FloatCache.seeded(torch.from_numpy(x), t) for x in (k, v))
    assert pk.data.shape[-1] == 32
    for index in (0, 7, 23):
        ref = jdecode_float(jnp.asarray(q).reshape(b, kv, g, d),
                            jnp.asarray(k).transpose(0, 1, 3, 2),
                            jnp.asarray(v).transpose(0, 1, 3, 2), index,
                            impl="jnp")
        got = decode_attention.decode_attention_float_plain(
            torch.from_numpy(q), pk, pv,
            torch.tensor([index], dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(ref).reshape(b, h, 1, d),
                                   atol=1e-5)


# --- bf16 cache scales ----------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
def test_bf16_scales_seed_and_write_bitwise(bits):
    """The seeded prefix and one written position, values and bf16 scales,
    bitwise against ``quantize_kv(..., scale_dtype=bfloat16)`` and
    ``update_quant_cache``: the scale is rounded to bf16 and the values
    quantized against the rounded scale."""
    r = np.random.default_rng(bits)
    b, h, p, t, d = 2, 3, 10, 16, 16
    prefix = (r.standard_normal((b, h, p, d)) * 3).astype(np.float32)
    new = (r.standard_normal((b, h, d)) * 3).astype(np.float32)
    jdt = jnp.int4 if bits == 4 else jnp.int8
    jc = jquant.quantize_kv(jnp.asarray(prefix).transpose(0, 1, 3, 2),
                            dtype=jdt, scale_dtype=jnp.bfloat16)
    seeded = quant.quantize_kv(torch.from_numpy(prefix), bits,
                               torch.bfloat16)
    assert seeded.scale.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        seeded.values()[..., :d].numpy(),
        np.asarray(jc.q.astype(jnp.int8)).transpose(0, 1, 3, 2))
    np.testing.assert_array_equal(
        seeded.scale.float().numpy(),
        np.asarray(jc.scale.astype(jnp.float32))[:, :, 0])
    # one position written at index 12 of a full-length cache
    full = jquant.QuantCache(jnp.zeros((b, h, d, t), jdt),
                             jnp.ones((b, h, 1, t), jnp.bfloat16))
    jw = jquant.update_quant_cache(
        full, jnp.asarray(new)[..., None], 12)
    kc, vc = (quant.QuantCache.empty(b, h, t, d, bits,
                                     scale_dtype=torch.bfloat16)
              for _ in range(2))
    decode_cache.write_quant_kv(kc, vc, torch.from_numpy(new),
                                torch.from_numpy(new),
                                torch.tensor([12], dtype=torch.int32))
    for c in (kc, vc):
        np.testing.assert_array_equal(
            c.values()[:, :, 12, :d].numpy(),
            np.asarray(jw.q.astype(jnp.int8))[..., 12])
        np.testing.assert_array_equal(
            c.scale.float().numpy(),
            np.asarray(jw.scale.astype(jnp.float32))[:, :, 0])


# --- rudalle_relax and the LayerNorm prescale -------------------------------------

@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("impl", ["auto", "pallas_interpret"])
def test_rudalle_forward_matches_jax(bidir, impl):
    """The port's fused form against JAX's unfused path (``auto`` on CPU:
    ``rudalle_relax_attention``) and its fused one through the Pallas
    kernel in interpret mode, prescale on, both prefix masks."""
    jmodel, variables, model = _pair(seed=6, prefix_bidirectional=bidir,
                                     attention_impl=impl, **RUDALLE)
    (got, ref), (got0, ref0), _ = _forward_pair(jmodel, variables, model)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3)
    np.testing.assert_allclose(got0.numpy(), np.asarray(ref0), atol=1e-3)


@pytest.mark.parametrize("bidir", [True, False])
def test_rudalle_teacher_forced_decode_matches_jax(bidir):
    """8 decode steps over the float cache with the guidance-doubled batch:
    sigma and max(v) span every row of both halves, positions <= index."""
    jmodel, variables, model = _pair(seed=7, prefix_bidirectional=bidir,
                                     **RUDALLE)
    _teacher_forced(jmodel, variables, model, atol=1e-3)


@pytest.mark.parametrize("d", [16, 13])
def test_rudalle_decode_attention_matches_jax(d):
    """``rudalle_decode_attention`` against JAX's
    ``_rudalle_decode_attention`` itself, over caches padded to 32 values
    a position (d 13: odd, sigma counts d columns only)."""
    r = np.random.default_rng(d)
    b, h, t = 4, 3, 20
    q = r.standard_normal((b, h, 1, d)).astype(np.float32)
    k, v = (r.standard_normal((b, h, t, d)).astype(np.float32)
            for _ in range(2))
    kc, vc = (FloatCache.seeded(torch.from_numpy(x), t) for x in (k, v))
    for index in (0, 9, 19):
        ref = jtransformer._rudalle_decode_attention(
            jnp.asarray(q), jnp.asarray(k).transpose(0, 1, 3, 2),
            jnp.asarray(v).transpose(0, 1, 3, 2), index)
        got = ptransformer.rudalle_decode_attention(
            torch.from_numpy(q), kc, vc,
            torch.tensor([index], dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-5, err_msg=f"index {index}")


# --- ln_matmul_fold -----------------------------------------------------------------

@pytest.mark.parametrize("prescale", [False, True])
def test_ln_matmul_fold_matches_jax_and_the_unfolded_model(prescale):
    flags = dict(ln_matmul_fold=True, cogview_layernorm_prescale=prescale)
    jmodel, variables, model = _pair(seed=8, **flags)
    (got, ref), (got0, ref0), _ = _forward_pair(jmodel, variables, model)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(got0.numpy(), np.asarray(ref0), atol=1e-4)
    plain = MakeAScene(TransformerConfig(
        **V_TINY, cogview_layernorm_prescale=prescale)).eval()
    plain.load_state_dict(model.state_dict(), strict=True)
    text, seg, img = (torch.from_numpy(a) for a in _tokens(model.cfg))
    with torch.no_grad():
        np.testing.assert_allclose(model(text, seg, img).numpy(),
                                   plain(text, seg, img).numpy(), atol=1e-4)
    _teacher_forced(jmodel, variables, model, atol=1e-4, steps=4)


# --- scan_layers trees ----------------------------------------------------------------

def test_stacked_tree_loads_as_the_unrolled_one():
    """A ``scan_layers`` model's stacked tree maps to the same state_dict
    as its unrolled form, and the port serves it with JAX's logits."""
    cfg = dict(V_TINY, scan_layers=True)
    jcfg = JTransformerConfig(**cfg)
    jmodel = JMakeAScene(jcfg)
    variables = jmodel.init(
        jax.random.PRNGKey(9), jnp.zeros((1, 8), jnp.int32),
        jnp.zeros((1, 16), jnp.int32), jnp.zeros((1, 16), jnp.int32))
    stacked = _np_tree(variables)
    assert "layers" in stacked["params"]
    unrolled = jtransformer.unstack_layer_params(
        dict(variables["params"]), jcfg.num_layers)
    mine = unstack_layer_params(stacked["params"], jcfg.num_layers)
    assert set(mine) == set(unrolled)
    a = transformer_from_flax(stacked, TransformerConfig(**cfg))
    b = transformer_from_flax(_np_tree({"params": unrolled}),
                              TransformerConfig(**V_TINY))
    assert set(a) == set(b)
    for key in a:
        assert torch.equal(a[key], b[key]), key
    model = MakeAScene(TransformerConfig(**cfg)).eval()
    model.load_state_dict(a, strict=True)
    text, seg, img = _tokens(model.cfg)
    ref = jmodel.apply(variables, _j(text), _j(seg), _j(img))
    with torch.no_grad():
        got = model(*(torch.from_numpy(x) for x in (text, seg, img)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


# --- the config -----------------------------------------------------------------------

REFUSED = (
    dict(num_kv_heads=3), dict(num_kv_heads=-1),
    dict(num_kv_heads=2, rudalle_relax=True),
    dict(num_kv_heads=2, decode_ring_tail=True),
    dict(num_kv_heads=2, kv_cache_dtype="int8", kv_cache_layout="packed",
         text_length=96, text_vocab_size=128),
    dict(num_kv_heads=2, decode_attention_impl="pallas"),
    dict(rudalle_relax=True, cogview_pb_relax=False),
    dict(rudalle_relax=True, kv_cache_dtype="int4"),
    dict(kv_scale_dtype="bfloat16"),
    dict(kv_scale_dtype="bfloat16", kv_cache_dtype="int8",
         kv_cache_layout="packed", text_length=96, text_vocab_size=128),
    dict(kv_scale_dtype="bfloat16", kv_cache_dtype="int8",
         decode_ring_tail=True),
    dict(kv_scale_dtype="float16"),
    dict(rudalle_relax=True, decode_q_rows=2),
)


@pytest.mark.parametrize("bad", REFUSED)
def test_config_refuses_what_jax_refuses(bad):
    with pytest.raises(JConfigError) as want:
        JTransformerConfig(**{**V_TINY, **bad})
    with pytest.raises(ConfigError) as got:
        TransformerConfig(**{**V_TINY, **bad})
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("ok", [
    dict(num_kv_heads=2), dict(num_kv_heads=4), dict(**RUDALLE),
    dict(ln_matmul_fold=True), dict(scan_layers=True),
    dict(kv_scale_dtype="bfloat16", kv_cache_dtype="int4"),
    dict(num_kv_heads=1, kv_cache_dtype="int8", kv_scale_dtype="bfloat16",
         ln_matmul_fold=True, cogview_layernorm_prescale=True)])
def test_config_takes_what_jax_takes(ok):
    jcfg = JTransformerConfig(**V_TINY, **ok)
    cfg = TransformerConfig(**V_TINY, **ok)
    assert cfg.kv_heads == jcfg.kv_heads
