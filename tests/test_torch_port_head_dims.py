"""Every head dim in the port (ROADMAP C3) vs the JAX package, on CPU.

The decode caches are allocated at the width that holds the head dim d
(``quant.decode_width``: D = 32, 64, 128, 256, or the least multiple of
256 above) and keep the columns past d at zero; B1/B6 zero-pad q, k, v to
``attention.kernel_head_dim(d)`` (64, 128, 256, or a multiple of 256 taken
in column passes).  Held here, on the same numpy inputs (2 heads, T <=
128):

  * the lane caches (int8, int4), the packed cache (int8, int4) and the
    float cache at d 48, 96, 256, the odd 33 and 47 (an int4 position's
    last byte pairs column d - 1 with a zero nibble), 264 and 320 (512-value
    positions): seeded and written values and scales bit for bit equal to
    the JAX package's (the Pallas writes in interpret mode; int4 nibbles
    unpacked), the columns past d still zero after the writes, and the
    reads within fp32 atol 1e-5 of ``decode_attention_int8`` (Pallas,
    interpret mode), ``decode_attention_packed`` and
    ``decode_attention_jnp``;
  * the B1/B6 padded route at d 160, 256, 264 and 320 (the twins on q, k,
    v, out, dO zero-padded to 256 or 512 with the true d's scale), forward
    and gradients, against the Pallas flash attention in interpret mode:
    fp32 atol 1e-5;
  * the cache layout kept at first use (``QuantCache.layout``): kept while
    the tensors stay, made anew when one is replaced, and a cache the
    kernels cannot read still raises ``check_caches``' own ``ValueError``.

On CPU every wrapper runs its plain twin, so these tests hold the layouts
and the arithmetic; the kernels are held to the twins on the card
(``chip_smoke.py``).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mas_tpu.ops import decode_cache as jdc
from mas_tpu.ops.attention import flash_attention as jflash_attention
from mas_tpu.ops.decode_attention import (decode_attention_jnp,
                                          transpose_cache)
from mas_tpu.ops.decode_cache import update_quant_caches_aliased
from mas_tpu.ops.quant import decode_attention_int8
from mas_tpu.ops.quant import quantize_kv as jquantize_kv

from mas_tpu_torch.ops import attention, decode_attention, decode_cache, quant
from mas_tpu_torch.ops.decode_attention import FloatCache

B, H, T, PREFIX = 1, 2, 128, 40
# padded to 64, 128; an instance; odd (int4: a last byte of one value and a
# zero nibble); above 256 (positions of 512 values, read in chunks of 256)
DIMS = (48, 96, 256, 33, 47, 264, 320)
WRITES = (PREFIX, PREFIX + 1, 77, T - 1)


def _rng(*seed):
    return np.random.default_rng(seed)


def _idx(i):
    return torch.tensor([i], dtype=torch.int32)


def _jdtype(bits):
    return jnp.int4 if bits == 4 else jnp.int8


def _jvalues(x):
    """JAX int8/int4 values as an int8 numpy array."""
    return np.asarray(x.astype(jnp.int8))


def _port_lane(jc, bits):
    """JAX cache [B, H, d, T] -> the port's padded lane cache [B, H, T, W]."""
    vals = _jvalues(jc.q).transpose(0, 1, 3, 2)
    d = vals.shape[-1]
    vals = np.pad(vals, ((0, 0),) * 3 + ((0, quant.decode_width(d) - d),))
    vals = torch.from_numpy(vals.copy())
    return quant.QuantCache(quant.pack_int4(vals) if bits == 4 else vals,
                            torch.from_numpy(np.asarray(jc.scale)[:, :, 0]
                                             .copy()), bits)


def _assert_lane_equal(got, jc, d, what):
    vals = got.values().numpy()
    np.testing.assert_array_equal(
        vals[..., :d], _jvalues(jc.q).transpose(0, 1, 3, 2),
        err_msg=f"{what}: values")
    assert not vals[..., d:].any(), f"{what}: the padding was written"
    np.testing.assert_array_equal(got.scale.numpy(),
                                  np.asarray(jc.scale)[:, :, 0],
                                  err_msg=f"{what}: scales")


# --- the lane caches (B3 writes, B2 reads) ----------------------------------

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("d", DIMS)
def test_lane_cache_padded_writes_bitwise_vs_jax(d, bits):
    r = _rng(d, bits)
    jk, jv = (jquantize_kv(jnp.asarray(r.standard_normal((B, H, d, T)),
                                       jnp.float32), dtype=_jdtype(bits))
              for _ in range(2))
    pk, pv = _port_lane(jk, bits), _port_lane(jv, bits)
    width = quant.cache_width(d, bits)
    assert pk.q.shape == quant.QuantCache.empty(B, H, T, d, bits).q.shape
    assert pk.q.shape[-1] == width
    for index in WRITES:
        kn = (3 * r.standard_normal((B, H, d, 1))).astype(np.float32)
        vn = r.standard_normal((B, H, d, 1)).astype(np.float32)
        jk, jv = update_quant_caches_aliased(
            jk, jv, jnp.asarray(kn), jnp.asarray(vn), jnp.int32(index),
            impl="pallas_interpret")
        tk, tv = torch.from_numpy(kn[..., 0]), torch.from_numpy(vn[..., 0])
        decode_cache._check(pk, pv, tk, tv, _idx(index))  # the kernel takes it
        decode_cache.write_quant_kv(pk, pv, tk, tv, _idx(index))
        _assert_lane_equal(pk, jk, d, f"k at {index}")
        _assert_lane_equal(pv, jv, d, f"v at {index}")


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("d", DIMS)
def test_lane_cache_padded_read_matches_jax(d, bits):
    r = _rng(10 + d, bits)
    jk, jv = (jquantize_kv(jnp.asarray(r.standard_normal((B, H, d, T)),
                                       jnp.float32), dtype=_jdtype(bits))
              for _ in range(2))
    pk, pv = _port_lane(jk, bits), _port_lane(jv, bits)
    q = r.standard_normal((B, H, 1, d)).astype(np.float32)
    assert quant._check(torch.from_numpy(q), pk, pv, _idx(0)) == \
        quant.cache_width(d, bits)
    for index in (0, PREFIX, T - 1):
        ref = decode_attention_int8(jnp.asarray(q), jk, jv, jnp.int32(index),
                                    impl="pallas_interpret")
        got = quant.decode_attention_quant(torch.from_numpy(q), pk, pv,
                                           _idx(index))
        assert got.shape == (B, H, 1, d)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_quantize_kv_pads_to_the_instance():
    """The port's own quantizer lays a [B, H, T, d] tensor out padded: the
    first d columns are the JAX package's values, the rest zero."""
    r = _rng(5)
    kv = r.standard_normal((B, H, T, 48)).astype(np.float32)
    got = quant.quantize_kv(torch.from_numpy(kv), 4)
    assert got.q.shape == (B, H, T, 32)
    ref = jquantize_kv(jnp.asarray(kv.transpose(0, 1, 3, 2)), dtype=jnp.int4)
    _assert_lane_equal(got, ref, 48, "quantize_kv")


# --- the packed cache (B10 writes, B2 reads) --------------------------------

def _assert_packed_equal(got, ref, d, what):
    width = quant.decode_width(d)
    vals = (quant.unpack_int4(got.kv) if got.bits == 4 else got.kv).numpy()
    want = _jvalues(ref.kv)
    for half in range(2):   # k, then v
        ours = vals[..., half * width:(half + 1) * width]
        np.testing.assert_array_equal(
            ours[..., :d], want[..., half * d:(half + 1) * d],
            err_msg=f"{what}: values of half {half}")
        assert not ours[..., d:].any(), f"{what}: the padding was written"
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale),
                                  err_msg=f"{what}: scales")


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("d", DIMS)
def test_packed_cache_padded_seed_and_writes_bitwise_vs_jax(d, bits):
    r = _rng(20 + d, bits)
    k, v = (3 * r.standard_normal((B, H, PREFIX, d)).astype(np.float32)
            for _ in range(2))
    ref = jdc.seed_packed_cache(jnp.asarray(k), jnp.asarray(v), T,
                                dtype=_jdtype(bits))
    got = decode_cache.seed_packed_cache(torch.from_numpy(k),
                                         torch.from_numpy(v), T, bits)
    assert got.kv.shape == (B, H, T, 2 * quant.cache_width(d, bits))
    _assert_packed_equal(got, ref, d, "seed")
    for index in WRITES:
        kn, vn = (3 * r.standard_normal((B, H, d)).astype(np.float32)
                  for _ in range(2))
        ref = jdc.update_packed_cache(ref, jnp.asarray(kn)[:, :, None],
                                      jnp.asarray(vn)[:, :, None], index,
                                      impl="pallas_interpret")
        tk, tv = torch.from_numpy(kn), torch.from_numpy(vn)
        decode_cache._check(*got.views(), tk, tv, _idx(index),
                            got.kv.shape[3])
        decode_cache.write_packed_kv(got, tk, tv, _idx(index))
        _assert_packed_equal(got, ref, d, f"write at {index}")


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("d", DIMS)
def test_packed_cache_padded_read_matches_jax(d, bits):
    r = _rng(30 + d, bits)
    k, v = (2 * r.standard_normal((B, H, T, d)).astype(np.float32)
            for _ in range(2))
    q = r.standard_normal((B, H, 1, d)).astype(np.float32)
    ref_cache = jdc.pack_quantize(jnp.asarray(k), jnp.asarray(v),
                                  dtype=_jdtype(bits))
    cache = decode_cache.seed_packed_cache(torch.from_numpy(k),
                                           torch.from_numpy(v), T, bits)
    for index in (0, 90, T - 1):
        ref = jdc.decode_attention_packed(jnp.asarray(q), ref_cache, index)
        got = decode_cache.decode_attention_packed(torch.from_numpy(q),
                                                   cache, _idx(index))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


# --- the float cache (B9 reads) ---------------------------------------------

@pytest.mark.parametrize("d", DIMS)
def test_float_cache_padded_seed_write_and_read_match_jax(d):
    r = _rng(40 + d)
    k, v = (r.standard_normal((B, H, PREFIX, d)).astype(np.float32)
            for _ in range(2))
    kc, vc = (FloatCache.seeded(torch.from_numpy(a), T) for a in (k, v))
    assert kc.data.shape == (B, H, T, quant.decode_width(d))
    jk, jv = (jax.lax.dynamic_update_slice(
        jnp.zeros((B, H, d, T)), transpose_cache(jnp.asarray(a)),
        (0, 0, 0, 0)) for a in (k, v))
    for index in WRITES:
        kn, vn = (r.standard_normal((B, H, d)).astype(np.float32)
                  for _ in range(2))
        decode_attention.write_float_kv(kc, vc, torch.from_numpy(kn),
                                        torch.from_numpy(vn), _idx(index))
        jk = jax.lax.dynamic_update_slice(jk, jnp.asarray(kn)[..., None],
                                          (0, 0, 0, index))
        jv = jax.lax.dynamic_update_slice(jv, jnp.asarray(vn)[..., None],
                                          (0, 0, 0, index))
    for got, want in ((kc, jk), (vc, jv)):
        np.testing.assert_array_equal(got.data[..., :d].numpy(),
                                      np.asarray(want).transpose(0, 1, 3, 2))
        assert not got.data[..., d:].any()
    q = r.standard_normal((B, H, 1, d)).astype(np.float32)
    decode_attention._check(torch.from_numpy(q), kc, vc, _idx(0))
    for index in (PREFIX, 77, T - 1):
        got = decode_attention.decode_attention_float(
            torch.from_numpy(q), kc, vc, _idx(index))
        ref = decode_attention_jnp(jnp.asarray(q), jk, jv, jnp.int32(index))
        assert got.shape == (B, H, 1, d)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("d", [264, 512])
def test_decode_caches_above_256_and_odd_int4_raise(d):
    """Such caches no longer raise: a head dim above 256 takes positions of
    the least multiple of 256 that holds it, an odd int4 head dim the next
    instance (its last byte pairs column d - 1 with a zero nibble); only a
    head dim below 1 raises."""
    assert quant.QuantCache.empty(B, H, T, d, 8).q.shape[-1] == 512
    assert decode_cache.PackedQuantCache.empty(B, H, T, d, 4).kv.shape[-1] \
        == 512
    assert FloatCache.seeded(torch.zeros(B, H, 4, d), T).data.shape[-1] == 512
    assert quant.QuantCache.empty(B, H, T, 47, 4).q.shape[-1] == 32
    with pytest.raises(ValueError, match="head_dim"):
        quant.QuantCache.empty(B, H, T, 0, 4)


# --- B1/B6: the padded route at d 160 and 256 --------------------------------

@pytest.mark.parametrize("t,prefix", [(64, 20), (128, 64)])
@pytest.mark.parametrize("d", [160, 256, 264, 320])
def test_attention_padded_route_above_128_matches_jax(d, t, prefix):
    """The route of the D = 256 kernels and of the column passes above: the
    twins on inputs zero-padded to 256 or 512 with the true d's scale,
    extra columns dropped, against the Pallas flash attention (interpret
    mode) and its gradient."""
    r = _rng(50 + d, t)
    q, k, v, do = (r.standard_normal((1, 2, t, d)).astype(np.float32)
                   for _ in range(4))
    out, vjp = jax.vjp(lambda q_, k_, v_: jflash_attention(
        q_, k_, v_, prefix, 64, 64, interpret=True),
        *map(jnp.asarray, (q, k, v)))
    ref_grads = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    width = attention.kernel_head_dim(d)
    assert width == (256 if d <= 256 else 512)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    attention._check(tq, tk, tv)
    pq, pk, pv, pdo = (attention.pad_head_dim(x, width)
                       for x in (tq, tk, tv, tdo))
    p_out, p_lse = attention.prefix_causal_attention_plain(
        pq, pk, pv, prefix, scale=attention.q_scale(d, tq.dtype))
    assert not p_out[..., d:].any()
    np.testing.assert_allclose(p_out[..., :d].numpy(), np.asarray(out),
                               atol=1e-5)
    grads = attention.prefix_causal_attention_bwd_plain(
        pq, pk, pv, p_out, p_lse, pdo, prefix, scale=1.0 / math.sqrt(d))
    for g, want in zip(grads, ref_grads):
        assert not g[..., d:].any()
        np.testing.assert_allclose(g[..., :d].numpy(), want, atol=1e-5)
    # and the wrappers' own route on CPU, as the model calls them
    got, lse = attention.flash_attention(tq, tk, tv, prefix)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), p_lse.numpy(), atol=1e-5)
    dqkv = attention.flash_attention_bwd(tq, tk, tv, got, lse, tdo, prefix)
    for i, want in enumerate(ref_grads):
        np.testing.assert_allclose(dqkv[:, :, i].transpose(1, 2).numpy(),
                                   want, atol=1e-5)


# --- the cache layout kept at first use ---------------------------------------

def test_cache_layout_is_kept_and_made_anew_for_new_tensors():
    kc = quant.QuantCache.empty(B, H, 16, 96, 4)
    first = kc.layout()
    assert first is kc.layout()
    assert first[:6] == (B, H, 16, 64, 4, 64)
    kc.q = torch.zeros(B, H, 16, 64, dtype=torch.uint8)
    assert kc.layout() is not first and kc.layout()[:6] == first[:6]
    packed = decode_cache.PackedQuantCache.empty(B, H, 16, 96, 8)
    views = packed.views()
    assert views is packed.views() and views[0].layout()[5] == 256
    packed.kv = torch.zeros_like(packed.kv)
    assert packed.views() is not views
    assert packed.views()[1].q.data_ptr() == packed.kv.data_ptr() + 128


def _bad_caches():
    """(k, v) cache pairs that no decode kernel takes, each with what
    ``check_caches`` says of it."""
    good = quant.QuantCache.empty(B, H, 16, 96, 8)
    strided = torch.ones(B, H, 32)[..., ::2]
    return {
        "scales not contiguous": (quant.QuantCache(good.q, strided, 8),
                                  good, "scales must be contiguous"),
        "other T": (good, quant.QuantCache.empty(B, H, 8, 96, 8),
                    "cache must be"),
        "unpadded width": (quant.QuantCache(good.q[..., :96], good.scale, 8),
                           good, "cache must be"),
        "bit widths": (good, quant.QuantCache.empty(B, H, 16, 96, 4),
                       "bit width"),
        "positions transposed": (
            quant.QuantCache(torch.zeros(B, 16, H, 128, dtype=torch.int8)
                             .transpose(1, 2), good.scale, 8),
            good, "strides"),
    }


@pytest.mark.parametrize("kind", list(_bad_caches()))
def test_bad_caches_raise_the_checks_own_error(kind):
    """A cache that no kernel reads has no record: the read's and the
    write's checks raise ``check_caches``' own error, also after a good
    call has kept the other cache's record."""
    k, v, match = _bad_caches()[kind]
    q = torch.zeros(B, H, 1, 96)
    new = torch.zeros(B, H, 96)
    good = quant.QuantCache.empty(B, H, 16, 96, 8)
    quant._check(q, good, good, _idx(3))
    with pytest.raises(ValueError, match=match) as want:
        quant.check_caches(k, v, B, H, 96, q.device, _idx(3))
    for check in (lambda: quant._check(q, k, v, _idx(3)),
                  lambda: decode_cache._check(k, v, new, new, _idx(3))):
        with pytest.raises(ValueError, match=match) as got:
            check()
        assert str(got.value) == str(want.value)


def test_kept_layout_still_checks_the_call():
    """The record is of the cache alone: each call still checks its q or
    new k/v against it, and the index tensor."""
    kc, vc = (quant.QuantCache.empty(B, H, 16, 96, 8) for _ in range(2))
    quant._check(torch.zeros(B, H, 1, 96), kc, vc, _idx(3))
    with pytest.raises(ValueError, match="cache must be"):
        quant._check(torch.zeros(B, H + 1, 1, 96), kc, vc, _idx(3))
    with pytest.raises(ValueError, match="cache must be"):   # 64-wide D
        quant._check(torch.zeros(B, H, 1, 64), kc, vc, _idx(3))
    with pytest.raises(ValueError, match="int32"):
        quant._check(torch.zeros(B, H, 1, 96), kc, vc,
                     torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="int32"):
        decode_cache._check(kc, vc, torch.zeros(B, H, 96),
                            torch.zeros(B, H, 96), torch.zeros(2).int())
    decode_cache._check(kc, vc, torch.zeros(B, H, 95),   # odd d fits 128
                        torch.zeros(B, H, 95), _idx(3))
    with pytest.raises(ValueError, match="one shape"):
        decode_cache._check(kc, vc, torch.zeros(B, H, 96),
                            torch.zeros(B, H, 95), _idx(3))
