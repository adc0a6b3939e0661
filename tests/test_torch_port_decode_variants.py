"""The port's float and packed decode caches vs the JAX package, on CPU.

Kernel twins (fp32, the same numpy inputs in both packages):
  * B9's twin ``decode_attention_float_plain`` against ``decode_attention_
    jnp`` and the Pallas ``_decode_kernel`` in interpret mode (JAX caches
    are [B, H, d, T], so they are transposed), at positions inside the
    prefix, mid-way and last: atol 1e-5 (fp32 sums in other orders);
  * B10's twin ``write_packed_kv_plain`` and ``seed_packed_cache`` against
    ``update_packed_cache(impl="pallas_interpret")`` and the JAX
    ``seed_packed_cache``, int8 and int4: values (nibbles unpacked and
    sign-extended) and scales bitwise equal;
  * the packed read against ``decode_attention_packed``: atol 1e-5.
The slice, tiny (2 layers, 2 heads of 64, text 48 + seg 4^2 + image 8^2 =
128 tokens, so the image grid is finer than the seg grid as at 512^2, and
``decode_attention_impl: "pallas_interpret"``, which sends JAX's decode
through the Pallas kernels in interpret mode): teacher-forced prefill and
decode logits within 1e-4, and greedy guided sampling token-equal to JAX,
for the float cache and the packed int8 and int4 caches; packed and lane
caches give equal tokens in the port.  Also: the packed ``ConfigError``s
are the JAX package's.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mas_tpu.models import sampler as jsampler
from mas_tpu.models.transformer import MakeAScene as JMakeAScene
from mas_tpu.ops import decode_cache as jdc
from mas_tpu.ops.decode_attention import decode_attention as jdecode
from mas_tpu.ops.decode_attention import decode_attention_jnp, transpose_cache
from mas_tpu.utils.config import ConfigError as JConfigError
from mas_tpu.utils.config import TransformerConfig as JTransformerConfig

from mas_tpu_torch.models.sampler import sample_tokens
from mas_tpu_torch.models.transformer import MakeAScene
from mas_tpu_torch.ops import decode_attention, decode_cache, quant
from mas_tpu_torch.ops.decode_attention import FloatCache
from mas_tpu_torch.utils.config import ConfigError, TransformerConfig

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_models import _t_pair, _tokens  # noqa: E402

SLICE = dict(num_layers=2, hidden_dim=128, num_attn_heads=2,
             image_vocab_size=96, seg_vocab_size=32, text_vocab_size=88,
             image_tokens_per_dim=8, seg_tokens_per_dim=4, text_length=48,
             decode_attention_impl="pallas_interpret")
CACHES = {"compute": dict(kv_cache_dtype="compute"),
          "packed-int8": dict(kv_cache_dtype="int8",
                              kv_cache_layout="packed"),
          "packed-int4": dict(kv_cache_dtype="int4",
                              kv_cache_layout="packed")}
B, H, T, D = 2, 3, 128, 64


def _rng(seed):
    return np.random.default_rng(seed)


def _idx(i):
    return torch.tensor([i], dtype=torch.int32)


# --- B9: the float cache ----------------------------------------------------

@pytest.mark.parametrize("index", [17, 63, 100, 127])
def test_b9_twin_matches_jax_jnp_and_pallas_interpret(index):
    r = _rng(index)
    q, k, v = (r.standard_normal(s).astype(np.float32)
               for s in ((B, H, 1, D), (B, H, T, D), (B, H, T, D)))
    kt, vt = (jnp.asarray(a.transpose(0, 1, 3, 2)) for a in (k, v))
    ref = decode_attention_jnp(jnp.asarray(q), kt, vt, index)
    interp = jdecode(jnp.asarray(q), kt, vt, index,
                                  impl="pallas_interpret")
    got = decode_attention.decode_attention_float(
        torch.from_numpy(q), FloatCache(torch.from_numpy(k)),
        FloatCache(torch.from_numpy(v)), _idx(index))
    assert got.shape == (B, H, 1, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(interp), atol=1e-5)


def test_float_cache_seed_and_write_match_jax_update():
    """``FloatCache.seeded`` + ``write_float_kv`` hold the same values as the
    JAX sampler's zero cache + ``dynamic_update_slice`` writes."""
    r = _rng(1)
    prefix = 40
    k, v = (r.standard_normal((B, H, prefix, D)).astype(np.float32)
            for _ in range(2))
    kc, vc = (FloatCache.seeded(torch.from_numpy(a), T) for a in (k, v))
    jk = jax.lax.dynamic_update_slice(
        jnp.zeros((B, H, D, T)), transpose_cache(jnp.asarray(k)),
        (0, 0, 0, 0))
    for index in (prefix, prefix + 1, T - 1):
        kn, vn = (r.standard_normal((B, H, D)).astype(np.float32)
                  for _ in range(2))
        decode_attention.write_float_kv(kc, vc, torch.from_numpy(kn),
                                        torch.from_numpy(vn), _idx(index))
        jk = jax.lax.dynamic_update_slice(jk, jnp.asarray(kn)[..., None],
                                          (0, 0, 0, index))
    np.testing.assert_array_equal(kc.data.numpy(),
                                  np.asarray(jk).transpose(0, 1, 3, 2))
    assert kc.data.shape == (B, H, T, D)
    assert not vc.data[:, :, prefix + 2:T - 1].any()


# --- B10: the packed cache --------------------------------------------------

def _jdtype(bits):
    return jnp.int4 if bits == 4 else jnp.int8


def _assert_packed_equal(got, ref, what):
    vals = quant.unpack_int4(got.kv) if got.bits == 4 else got.kv
    np.testing.assert_array_equal(vals.numpy(),
                                  np.asarray(ref.kv.astype(jnp.int8)),
                                  err_msg=f"{what}: values")
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale),
                                  err_msg=f"{what}: scales")


@pytest.mark.parametrize("bits", [8, 4])
def test_b10_twin_and_seed_bitwise_vs_jax_pallas_interpret(bits):
    r = _rng(bits)
    prefix = 40
    k, v = (3 * r.standard_normal((B, H, prefix, D)).astype(np.float32)
            for _ in range(2))
    ref = jdc.seed_packed_cache(jnp.asarray(k), jnp.asarray(v), T,
                                dtype=_jdtype(bits))
    got = decode_cache.seed_packed_cache(torch.from_numpy(k),
                                         torch.from_numpy(v), T, bits)
    assert got.kv.shape == (B, H, T, 2 * D if bits == 8 else D)
    _assert_packed_equal(got, ref, "seed")
    for index in (prefix, prefix + 1, 77, T - 1):
        kn, vn = (3 * r.standard_normal((B, H, D)).astype(np.float32)
                  for _ in range(2))
        ref = jdc.update_packed_cache(ref, jnp.asarray(kn)[:, :, None],
                                      jnp.asarray(vn)[:, :, None], index,
                                      impl="pallas_interpret")
        decode_cache.write_packed_kv(got, torch.from_numpy(kn),
                                     torch.from_numpy(vn), _idx(index))
        _assert_packed_equal(got, ref, f"write at {index}")


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("index", [39, 90, 127])
def test_packed_read_matches_jax(bits, index):
    r = _rng(100 + index)
    k, v = (2 * r.standard_normal((B, H, T, D)).astype(np.float32)
            for _ in range(2))
    q = r.standard_normal((B, H, 1, D)).astype(np.float32)
    ref_cache = jdc.pack_quantize(jnp.asarray(k), jnp.asarray(v),
                                  dtype=_jdtype(bits))
    ref = jdc.decode_attention_packed(jnp.asarray(q), ref_cache, index)
    cache = decode_cache.seed_packed_cache(torch.from_numpy(k),
                                           torch.from_numpy(v), T, bits)
    got = decode_cache.decode_attention_packed(torch.from_numpy(q), cache,
                                               _idx(index))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    # the views read the packed buffer in place
    kview, vview = cache.views()
    assert kview.q.data_ptr() == cache.kv.data_ptr()
    assert quant.position_stride(vview.q) == cache.kv.shape[-1]


def test_position_stride_rejects_other_layouts():
    lane = quant.QuantCache.empty(2, 3, 16, 64, 8)
    assert quant.position_stride(lane.q) == 64
    with pytest.raises(ValueError, match="strides"):
        quant.position_stride(lane.q.transpose(1, 2))
    with pytest.raises(ValueError, match="strides"):
        quant.position_stride(lane.q[:, :, :8])      # rows 16 positions apart


# --- the slice, tiny --------------------------------------------------------

def _jax_caches(jcfg, kvs):
    """The JAX sampler's seeded caches for the config's cache kind."""
    total = jcfg.total_length
    if jcfg.kv_cache_layout == "packed":
        return tuple((jdc.seed_packed_cache(k, v, total,
                                            dtype=_jdtype(
                                                4 if jcfg.kv_cache_dtype
                                                == "int4" else 8)), None)
                     for k, v in kvs)
    full = jnp.zeros(kvs[0][0].shape[:2] + (jcfg.head_dim, total))
    return tuple(tuple(jax.lax.dynamic_update_slice(
        full, transpose_cache(t), (0, 0, 0, 0)) for t in kv)
        for kv in kvs)


@pytest.mark.parametrize("cache", list(CACHES))
def test_teacher_forced_logits_match_jax(cache):
    jmodel, variables, model = _t_pair(seed=21, **SLICE, **CACHES[cache])
    cfg = model.cfg
    assert cfg.total_length == 128
    text, seg, img = _tokens(cfg, seed=22)
    j = lambda a: jnp.asarray(a, jnp.int32)
    ref0, jkv = jmodel.apply(variables, j(text), j(seg),
                             method=JMakeAScene.prefill)
    jcaches = _jax_caches(jmodel.cfg, jkv)
    step_fn = jax.jit(lambda v, tok, step, c: jmodel.apply(
        v, tok, step, c, method=JMakeAScene.decode_step))
    with torch.no_grad():
        got0, kvs = model.prefill(torch.from_numpy(text),
                                  torch.from_numpy(seg))
        caches = model.allocate_caches(kvs, 2)
        np.testing.assert_allclose(got0.numpy(), np.asarray(ref0),
                                   atol=1e-4)
        for step in range(10):
            tok = img[:, step:step + 1]
            ref, jcaches = step_fn(variables, j(tok), step, jcaches)
            got = model.decode_step(torch.from_numpy(tok), step, caches)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       atol=1e-4, err_msg=f"step {step}")


@pytest.mark.parametrize("cache", list(CACHES))
def test_greedy_tokens_match_jax(cache):
    jmodel, variables, model = _t_pair(seed=31, **SLICE, **CACHES[cache])
    text, seg, _ = _tokens(model.cfg, seed=32)
    j = lambda a: jnp.asarray(a, jnp.int32)
    ref = jsampler.sample_tokens(jmodel, variables, j(text), j(seg),
                                 jax.random.PRNGKey(0), guidance_scale=3.0,
                                 top_k=1)
    got = sample_tokens(model, torch.from_numpy(text), torch.from_numpy(seg),
                        torch.Generator().manual_seed(0),
                        guidance_scale=3.0, top_k=1)
    assert got.shape == (2, model.cfg.image_length)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("bits", ["int8", "int4"])
def test_packed_and_lane_caches_give_equal_tokens(bits):
    _, _, packed = _t_pair(seed=41, **SLICE, kv_cache_dtype=bits,
                           kv_cache_layout="packed")
    lane = MakeAScene(TransformerConfig(**SLICE, kv_cache_dtype=bits)).eval()
    lane.load_state_dict(packed.state_dict())
    text, seg, _ = (torch.from_numpy(a) for a in _tokens(packed.cfg,
                                                          seed=42))
    toks = [sample_tokens(m, text, seg, torch.Generator().manual_seed(0),
                          guidance_scale=3.0, top_k=1)
            for m in (packed, lane)]
    assert torch.equal(toks[0], toks[1])


# --- config -----------------------------------------------------------------

@pytest.mark.parametrize("knob,match", [
    (dict(kv_cache_layout="packed"), "quantized"),
    (dict(kv_cache_layout="lane_aliased"), "quantized"),
    (dict(kv_cache_layout="packed", kv_cache_dtype="int8",
          text_length=40), "128"),
    (dict(kv_cache_layout="lane_aliased", kv_cache_dtype="int4",
          text_length=40), "128")])
def test_packed_config_errors_match_jax(knob, match):
    fields = dict(SLICE, **knob)
    with pytest.raises(JConfigError, match=match):
        JTransformerConfig(**fields)
    with pytest.raises(ConfigError, match=match):
        TransformerConfig(**fields)


@pytest.mark.parametrize("layout", ["packed", "lane_aliased"])
def test_packed_configs_both_packages_accept(layout):
    for cls in (JTransformerConfig, TransformerConfig):
        cfg = cls(**SLICE, kv_cache_dtype="int4", kv_cache_layout=layout)
        assert cfg.total_length % 128 == 0


# --- wrappers ---------------------------------------------------------------

def test_new_wrappers_on_cpu_do_not_count_launches():
    counted = (decode_attention.decode_attention_float,
               decode_cache.write_packed_kv, quant.decode_attention_quant)
    before = [fn.launches for fn in counted]
    q = torch.zeros(1, 2, 1, 64)
    kc = FloatCache(torch.zeros(1, 2, 8, 64))
    decode_attention.decode_attention_float(q, kc, kc, _idx(3))
    cache = decode_cache.PackedQuantCache.empty(1, 2, 8, 64, 4)
    decode_cache.write_packed_kv(cache, q[:, :, 0], q[:, :, 0], _idx(3))
    decode_cache.decode_attention_packed(q, cache, _idx(3))
    assert before == [fn.launches for fn in counted]


def test_new_wrappers_reject_meta_tensors():
    q = torch.empty(1, 2, 1, 64, device="meta")
    kc = FloatCache(torch.empty(1, 2, 8, 64, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        decode_attention.decode_attention_float(q, kc, kc, _idx(3))
    cache = decode_cache.PackedQuantCache.empty(1, 2, 8, 64, 8)
    with pytest.raises(ValueError, match="cpu or cuda"):
        decode_cache.write_packed_kv(cache, q[:, :, 0], q[:, :, 0], _idx(3))


def test_b9_and_b10_checks_reject_bad_inputs():
    q = torch.zeros(1, 2, 1, 64)
    bad = FloatCache(torch.zeros(1, 2, 8, 64, dtype=torch.float16))
    with pytest.raises(ValueError, match="bf16 or fp32"):
        decode_attention._check(q, bad, bad, _idx(3))
    good = FloatCache(torch.zeros(1, 2, 8, 64))
    with pytest.raises(ValueError, match="int32"):
        decode_attention._check(q, good, good,
                                torch.zeros(1, dtype=torch.int64))
    cache = decode_cache.PackedQuantCache.empty(1, 2, 8, 64, 4)
    new = torch.zeros(1, 3, 64)
    with pytest.raises(ValueError, match="cache must be"):
        decode_cache._check(*cache.views(), new, new, _idx(3),
                            cache.kv.shape[3])
    packed8 = decode_cache.PackedQuantCache.empty(1, 2, 16, 64, 8)
    with pytest.raises(ValueError, match="64 bytes apart"):   # B3 takes lanes
        decode_cache._check(*packed8.views(), q[:, :, 0], q[:, :, 0],
                            _idx(3))


def test_sample_512_config_is_the_float_cache_geometry():
    """The 512^2 serving config that chip_smoke.py builds (and README
    shows) loads unchanged: transformer_512's transformer over a float
    cache, T 1408, img_512's VQ with a 32^2 latent grid."""
    from mas_tpu_torch.utils.config import VQModelConfig

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    raw = chip_smoke.sample_512_raw("ckpt.pt")
    t = TransformerConfig.from_dict(raw["transformer"])
    v = VQModelConfig.from_dict(raw["model"])
    assert (t.kv_cache_dtype, t.total_length, t.prefix_length,
            t.image_tokens_per_dim) == ("compute", 1408, 384, 32)
    assert v.resolution == 512 and v.latent_resolution == 32
    assert (raw["guidance_scale"], raw["top_k"], len(raw["captions"]),
            raw["transformer_checkpoint"]) == (3.0, 64, 4, "ckpt.pt")
