"""Port ops vs the JAX package, on CPU.

Each kernel module of ``mas_tpu_torch`` is held against its JAX
counterpart on the same numpy inputs: the CPU path of every wrapper is the
kernel's plain twin, and the JAX side runs its Pallas kernel in interpret
mode (or its jnp path), as the JAX package's own tests do.  Tolerances are
fp32 accumulation-order tolerances; quantization and the cache write are
compared bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mas_tpu.ops import norms as jnorms
from mas_tpu.ops.attention import (_flash_fwd, flash_attention,
                                   prefix_causal_attention_jnp)
from mas_tpu.ops.decode_cache import update_quant_caches_aliased
from mas_tpu.ops.pallas.gn_swish import _gn_swish_fwd_stats_pallas
from mas_tpu.ops.quant import decode_attention_int8
from mas_tpu.ops.quant import dequantize_kv as jdequantize_kv
from mas_tpu.ops.quant import quantize_kv as jquantize_kv

from mas_tpu_torch.ops import attention, decode_cache, gn_swish, norms, quant


def _np(x):
    return np.asarray(x.astype(jnp.float32) if hasattr(x, "astype")
                      and x.dtype == jnp.int4 else x)


def _rng(seed):
    return np.random.default_rng(seed)


# --- B1: prefix-causal attention forward -----------------------------------

@pytest.mark.parametrize("prefix", [0, 20, 48])
def test_attention_plain_matches_pallas_interpret(prefix):
    r = _rng(prefix)
    q, k, v = (r.standard_normal((2, 2, 48, 64)).astype(np.float32)
               for _ in range(3))
    out, lse = attention.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        prefix)
    j_out, j_lse = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              prefix, 16, 16, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=1e-5)
    j_public = flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), prefix, 16, 16,
                               interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_public), atol=1e-5)


@pytest.mark.parametrize("prefix", [0, 17, 37])
def test_attention_plain_matches_jnp_ragged_length(prefix):
    """T = 37 is no multiple of any tile."""
    r = _rng(100 + prefix)
    q, k, v = (r.standard_normal((1, 3, 37, 64)).astype(np.float32)
               for _ in range(3))
    out, lse = attention.prefix_causal_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        prefix)
    ref = prefix_causal_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), prefix)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    # lse is the log of the softmax denominator over the visible keys
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / 8.0
    pos = np.arange(37)
    mask = (pos[None] <= pos[:, None]) | (
        (pos[:, None] < prefix) & (pos[None] < prefix))
    s = np.where(mask, s, -np.inf)
    m = s.max(-1)
    np.testing.assert_allclose(
        lse.numpy(), m + np.log(np.exp(s - m[..., None]).sum(-1)), atol=1e-5)


# --- quantization ----------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_kv_bitwise(bits):
    r = _rng(bits)
    kv = (r.standard_normal((2, 3, 64, 40)) * r.uniform(
        0.01, 10.0, (2, 3, 1, 40))).astype(np.float32)     # JAX [B,H,d,T]
    kv[0, 0, :, 3] = 0.0                                     # eps floor
    ref = jquantize_kv(jnp.asarray(kv),
                       dtype=jnp.int4 if bits == 4 else jnp.int8)
    got = quant.quantize_kv(torch.from_numpy(kv.transpose(0, 1, 3, 2)),
                            bits)
    np.testing.assert_array_equal(
        got.values().numpy().transpose(0, 1, 3, 2).astype(np.float32),
        _np(ref.q))
    np.testing.assert_array_equal(got.scale.numpy(),
                                  np.asarray(ref.scale)[:, :, 0])
    np.testing.assert_array_equal(
        quant.dequantize_kv(got).numpy().transpose(0, 1, 3, 2),
        np.asarray(jdequantize_kv(ref)))


def test_int4_pack_roundtrip_negative_nibbles():
    vals = torch.tensor([[-8, -7, -1, 0, 1, 7, -3, 5]], dtype=torch.int8)
    packed = quant.pack_int4(vals)
    assert packed.dtype == torch.uint8 and packed.shape == (1, 4)
    # low nibble = even dim: (-8 & 15) | ((-7 & 15) << 4) = 0x98
    assert int(packed[0, 0]) == 0x98
    np.testing.assert_array_equal(quant.unpack_int4(packed).numpy(),
                                  vals.numpy())
    every = torch.arange(-8, 8, dtype=torch.int8).repeat(2)
    np.testing.assert_array_equal(
        quant.unpack_int4(quant.pack_int4(every)).numpy(), every.numpy())


# --- B2: quantized decode attention ----------------------------------------

def _jax_caches(r, b, h, d, t, bits):
    dtype = jnp.int4 if bits == 4 else jnp.int8
    k = jquantize_kv(jnp.asarray(r.standard_normal((b, h, d, t)),
                                 jnp.float32), dtype=dtype)
    v = jquantize_kv(jnp.asarray(r.standard_normal((b, h, d, t)),
                                 jnp.float32), dtype=dtype)
    return k, v


def _port_cache(jc, bits):
    """JAX QuantCache [B, H, d, T] -> the port's [B, H, T, d(/2)] cache."""
    vals = torch.from_numpy(
        _np(jc.q).astype(np.int8).transpose(0, 1, 3, 2).copy())
    return quant.QuantCache(quant.pack_int4(vals) if bits == 4 else vals,
                            torch.from_numpy(np.asarray(jc.scale)[:, :, 0]
                                             .copy()), bits)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("index", [0, 5, 39])
def test_decode_attention_matches_jnp(bits, index):
    r = _rng(10 * bits + index)
    b, h, d, t = 2, 3, 64, 40
    jk, jv = _jax_caches(r, b, h, d, t, bits)
    q = r.standard_normal((b, h, 1, d)).astype(np.float32)
    ref = decode_attention_int8(jnp.asarray(q), jk, jv, jnp.int32(index),
                                impl="jnp")
    got = quant.decode_attention_quant(
        torch.from_numpy(q), _port_cache(jk, bits), _port_cache(jv, bits),
        torch.tensor([index], dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


# --- B3: quantize-and-write ------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("index", [0, 77, 127])
def test_cache_write_matches_pallas_interpret_bitwise(bits, index):
    r = _rng(1000 + 10 * bits + index)
    b, h, d, t = 2, 2, 64, 128
    jk, jv = _jax_caches(r, b, h, d, t, bits)
    kn = (r.standard_normal((b, h, d, 1)) * 3).astype(np.float32)
    vn = r.standard_normal((b, h, d, 1)).astype(np.float32)
    ref_k, ref_v = update_quant_caches_aliased(
        jk, jv, jnp.asarray(kn), jnp.asarray(vn), jnp.int32(index),
        impl="pallas_interpret")
    pk, pv = _port_cache(jk, bits), _port_cache(jv, bits)
    decode_cache.write_quant_kv(
        pk, pv, torch.from_numpy(kn[..., 0]), torch.from_numpy(vn[..., 0]),
        torch.tensor([index], dtype=torch.int32))
    for got, ref in ((pk, ref_k), (pv, ref_v)):
        want = _port_cache(ref, bits)
        np.testing.assert_array_equal(got.q.numpy(), want.q.numpy())
        np.testing.assert_array_equal(got.scale.numpy(), want.scale.numpy())


def test_cache_write_touches_only_index():
    r = _rng(7)
    k = quant.quantize_kv(torch.from_numpy(
        r.standard_normal((1, 2, 16, 64)).astype(np.float32)), 4)
    v = quant.quantize_kv(torch.from_numpy(
        r.standard_normal((1, 2, 16, 64)).astype(np.float32)), 4)
    before = [t.clone() for t in (k.q, k.scale, v.q, v.scale)]
    new = torch.from_numpy(r.standard_normal((1, 2, 64)).astype(np.float32))
    decode_cache.write_quant_kv(k, v, new, new,
                                torch.tensor([9], dtype=torch.int32))
    for old, cur in zip(before, (k.q, k.scale, v.q, v.scale)):
        keep = [i for i in range(16) if i != 9]
        assert torch.equal(old[:, :, keep], cur[:, :, keep])
    assert not torch.equal(before[0][:, :, 9], k.q[:, :, 9])


# --- B4: GroupNorm + swish -------------------------------------------------

@pytest.mark.parametrize("shift", [0.0, 50.0])
def test_gn_swish_matches_pallas_interpret_and_jnp(shift):
    """shift: a large common mean, where E[x^2] - mean^2 cancels.  There
    the fp32 mean itself is rounded by ~4e-6 (one ulp of 50), which any
    fp32 order of summation shows, so that case is held against a float64
    reference at 1e-4 instead of against the JAX fp32 paths."""
    r = _rng(int(shift))
    x = (r.standard_normal((2, 8, 8, 64)) + shift).astype(np.float32)
    s = r.standard_normal(64).astype(np.float32)
    b = r.standard_normal(64).astype(np.float32)
    out, stats = gn_swish.gn_swish(torch.from_numpy(x), torch.from_numpy(s),
                                   torch.from_numpy(b), 32, 1e-6)
    xg = x.astype(np.float64).reshape(2, 64, 32, 2)
    mean = xg.mean(axis=(1, 3))
    rstd = 1.0 / np.sqrt(xg.var(axis=(1, 3)) + 1e-6)
    np.testing.assert_allclose(stats[:, 0].numpy(), mean, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(stats[:, 1].numpy(), rstd, rtol=1e-5)
    if shift:
        a = ((xg - mean[:, None, :, None]) * rstd[:, None, :, None]
             ).reshape(2, 8, 8, 64) * s + b
        np.testing.assert_allclose(out.numpy(), a / (1 + np.exp(-a)),
                                   atol=1e-4)
        return
    ref = jnorms.group_norm_swish(jnp.asarray(x), jnp.asarray(s),
                                  jnp.asarray(b), impl="jnp")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    p_out, p_stats = _gn_swish_fwd_stats_pallas(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 32, 1e-6,
        interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(p_out), atol=1e-5)
    np.testing.assert_allclose(stats.numpy(), np.asarray(p_stats), atol=1e-5)


def test_group_norm_and_layer_norm_match_jnp():
    r = _rng(3)
    x = r.standard_normal((2, 4, 4, 64)).astype(np.float32)
    s = r.standard_normal(64).astype(np.float32)
    b = r.standard_normal(64).astype(np.float32)
    got = norms.group_norm(torch.from_numpy(x), torch.from_numpy(s),
                           torch.from_numpy(b))
    ref = jnorms.group_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    y = r.standard_normal((3, 5, 64)).astype(np.float32) * 4 + 2
    got = norms.layer_norm(torch.from_numpy(y), torch.from_numpy(s),
                           torch.from_numpy(b))
    ref = jnorms.layer_norm(jnp.asarray(y), jnp.asarray(s), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


# --- wrappers: CPU twins, no silent acceptance of other devices -----------

def test_wrappers_on_cpu_do_not_count_launches():
    before = (attention.flash_attention.launches,
              quant.decode_attention_quant.launches,
              decode_cache.write_quant_kv.launches,
              gn_swish.gn_swish.launches)
    x = torch.zeros(1, 4, 4, 32)
    gn_swish.gn_swish(x, torch.ones(32), torch.zeros(32))
    q = torch.zeros(1, 1, 8, 64)
    attention.flash_attention(q, q, q, 0)
    assert before == (attention.flash_attention.launches,
                      quant.decode_attention_quant.launches,
                      decode_cache.write_quant_kv.launches,
                      gn_swish.gn_swish.launches)


def test_wrappers_reject_meta_tensors():
    q = torch.empty(1, 1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        attention.flash_attention(q, q, q, 0)
    x = torch.empty(1, 4, 4, 32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        gn_swish.gn_swish(x, torch.ones(32), torch.zeros(32))


def test_kernel_checks_reject_bad_inputs():
    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="head_dim"):
        attention._check(q, q, q)
    x = torch.zeros(1, 4, 4, 96)
    with pytest.raises(ValueError, match="power of two"):
        gn_swish._check(x, torch.ones(96), torch.zeros(96), 32)
    k = quant.QuantCache.empty(1, 2, 16, 64, 4)
    v = quant.QuantCache.empty(1, 2, 16, 64, 8)
    with pytest.raises(ValueError, match="bit width"):
        quant._check(torch.zeros(1, 2, 1, 64), k, v,
                     torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        decode_cache._check(k, quant.QuantCache.empty(1, 2, 16, 64, 4),
                            torch.zeros(1, 2, 64), torch.zeros(1, 2, 64),
                            torch.zeros(1, dtype=torch.int64))
