"""The split decode read of kernels B2 and B9 vs the JAX package, on CPU.

``csrc/decode_quant.cu`` gives each (b, h) row ``decode_split(B * H)``
blocks of one thread-block cluster: block j takes positions [j c,
(j + 1) c) of [0, valid) with c = ceil(valid / S), keeps its own softmax
state (m, l, acc), and rank 0 merges the states in rank order.  The CUDA
kernel runs only on the card; here ``split_merge`` repeats its arithmetic
in torch, and is held against

  * the float cache (B9): ``decode_attention_jnp`` (fp32 atol 1e-5; bf16
    atol 1e-2, rtol 1e-2, the rule of the kernel checks: the jnp path
    rounds p to the cache dtype, the kernel keeps it fp32);
  * the int8 cache (B2): the Pallas ``_int8_decode_kernel`` in interpret
    mode (fp32 atol 1e-5),

for S in {1, 3, 8}, head dims 32, 64 and 128, and index 0, S - 2, 383 and
T - 1.  Index 0 and S - 2 leave chunks empty: they must add nothing and no
NaN.  The port's plain twins are held to the same references at the same
head dims.  Also: the host's split plan depends on B * H alone, and B3's
twin writes the JAX package's bits at head dims 32 and 128.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mas_tpu.ops.decode_attention import decode_attention_jnp
from mas_tpu.ops.decode_cache import update_quant_caches_aliased
from mas_tpu.ops.quant import decode_attention_int8
from mas_tpu.ops.quant import quantize_kv as jquantize_kv

from mas_tpu_torch.ops import decode_attention, decode_cache, quant
from mas_tpu_torch.ops.attention import q_scale
from mas_tpu_torch.ops.decode_attention import FloatCache

B, H, T = 1, 2, 512
NEG = -1e30


def _index(where: str, split: int) -> int:
    return {"0": 0, "S-2": max(split - 2, 0), "383": 383, "T-1": T - 1}[where]


def split_merge(qs, k, ks, v, vs, index: int, split: int):
    """The kernel's arithmetic in fp32: qs [B, H, d] the scaled query, k, v
    [B, H, T, d] values, ks, vs [B, H, T] scales (ones for a float cache).
    Returns [B, H, d] and whether some chunk was empty."""
    valid = min(index + 1, k.shape[2])
    chunk = -(-valid // split)
    states, empty = [], False
    for rank in range(split):
        lo = min(rank * chunk, valid)
        hi = min(lo + chunk, valid)
        if hi == lo:
            empty = True
            states.append((torch.full(qs.shape[:2], NEG),
                           torch.zeros(qs.shape[:2]), torch.zeros(qs.shape)))
            continue
        s = torch.einsum("bhd,bhtd->bht", qs, k[:, :, lo:hi]) * ks[:, :, lo:hi]
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        acc = torch.einsum("bht,bhtd->bhd", p * vs[:, :, lo:hi],
                           v[:, :, lo:hi])
        states.append((m, p.sum(-1), acc))
    mm = torch.stack([m for m, _, _ in states]).amax(0)
    ll = sum(l * torch.exp(m - mm) for m, l, _ in states)
    aa = sum(a * torch.exp(m - mm)[..., None] for m, _, a in states)
    return aa / ll[..., None], empty


def _float_inputs(d, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, H, 1, d)).astype(np.float32),
            r.standard_normal((B, H, T, d)).astype(np.float32),
            r.standard_normal((B, H, T, d)).astype(np.float32))


@pytest.mark.parametrize("where", ["0", "S-2", "383", "T-1"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("split", [1, 3, 8])
def test_split_merge_float_cache_matches_jax(split, d, where):
    index = _index(where, split)
    q, k, v = _float_inputs(d, 10 * d + split)
    ref = np.asarray(decode_attention_jnp(
        jnp.asarray(q), jnp.asarray(k.transpose(0, 1, 3, 2)),
        jnp.asarray(v.transpose(0, 1, 3, 2)), index))[:, :, 0]
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    ones = torch.ones(B, H, T)
    got, empty = split_merge(tq[:, :, 0] * q_scale(d, tq.dtype), tk, ones, tv,
                             ones, index, split)
    assert bool(torch.isfinite(got).all())
    assert empty == (index + 1 < split)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    twin = decode_attention.decode_attention_float(
        tq, FloatCache(tk), FloatCache(tv),
        torch.tensor([index], dtype=torch.int32))
    np.testing.assert_allclose(twin[:, :, 0].numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("split", [1, 3, 8])
def test_split_merge_bf16_float_cache_within_kernel_tolerance(split, d):
    """bf16 q and cache: q is scaled in bf16 (for d 32 and 128 the scale
    and the product round), as the JAX package's q * asarray(scale, q.dtype)
    and the port's twin."""
    index = 383
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _float_inputs(d, 20 * d + split))
    ref = decode_attention_jnp(
        *(jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in
          (q, k.transpose(2, 3), v.transpose(2, 3))), index)
    ref = np.asarray(ref.astype(jnp.float32))[:, :, 0]
    qs = (q[:, :, 0] * q_scale(d, q.dtype)).float()
    ones = torch.ones(B, H, T)
    got, _ = split_merge(qs, k.float(), ones, v.float(), ones, index, split)
    got = got.bfloat16().float().numpy()
    np.testing.assert_allclose(got, ref, atol=1e-2, rtol=1e-2)
    twin = decode_attention.decode_attention_float_plain(
        q, FloatCache(k), FloatCache(v),
        torch.tensor([index], dtype=torch.int32))
    np.testing.assert_allclose(twin[:, :, 0].float().numpy(), ref, atol=1e-2,
                               rtol=1e-2)


@pytest.mark.parametrize("where", ["0", "S-2", "383", "T-1"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("split", [1, 3, 8])
def test_split_merge_int8_cache_matches_pallas_interpret(split, d, where):
    index = _index(where, split)
    r = np.random.default_rng(30 * d + split)
    q = r.standard_normal((B, H, 1, d)).astype(np.float32)
    jk, jv = (jquantize_kv(jnp.asarray(r.standard_normal((B, H, d, T)),
                                       jnp.float32)) for _ in range(2))
    ref = np.asarray(decode_attention_int8(
        jnp.asarray(q), jk, jv, jnp.int32(index),
        impl="pallas_interpret"))[:, :, 0]
    kc, vc = (quant.QuantCache(
        torch.from_numpy(np.asarray(c.q).transpose(0, 1, 3, 2).copy()),
        torch.from_numpy(np.asarray(c.scale)[:, :, 0].copy()), 8)
        for c in (jk, jv))
    tq = torch.from_numpy(q)
    got, empty = split_merge(tq[:, :, 0] * (1.0 / math.sqrt(d)),
                             kc.q.float(), kc.scale, vc.q.float(), vc.scale,
                             index, split)
    assert bool(torch.isfinite(got).all())
    assert empty == (index + 1 < split)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    twin = quant.decode_attention_quant(
        tq, kc, vc, torch.tensor([index], dtype=torch.int32))
    np.testing.assert_allclose(twin[:, :, 0].numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("rows,split", [(1, 8), (32, 8), (128, 8), (256, 4),
                                        (512, 2), (2048, 1), (4096, 1)])
def test_decode_split_depends_on_rows_only(rows, split):
    """S from B * H alone: the least power of two that gives 4 blocks on
    each of the H100's 132 SMs, at most 8 (one portable cluster).  Batch 4
    with guidance (8 rows x 16 heads) takes 8, batch 64 (128 x 16) 1."""
    assert quant.decode_split(rows) == split
    assert rows * split >= 4 * 132 or split == quant.MAX_SPLIT
    assert split == 1 or rows * split // 2 < 4 * 132
    # (b, h) pairs with one product split alike
    assert {quant.decode_split(b * (rows // b))
            for b in (1, 2, 4) if rows % b == 0} == {split}


def test_decode_split_rejects_no_rows():
    with pytest.raises(ValueError, match="rows"):
        quant.decode_split(0)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("d", [32, 128])
def test_cache_write_twin_other_head_dims_bitwise(d, bits):
    """B3's twin at head dims 32 and 128 (its Triton kernel takes d as a
    constexpr over a masked power-of-two block) against the JAX package's
    lane write in interpret mode: values and scales bit for bit."""
    r = np.random.default_rng(d + bits)
    dtype = jnp.int4 if bits == 4 else jnp.int8
    jk, jv = (jquantize_kv(jnp.asarray(r.standard_normal((2, 2, d, 128)),
                                       jnp.float32), dtype=dtype)
              for _ in range(2))
    kn = (r.standard_normal((2, 2, d, 1)) * 3).astype(np.float32)
    vn = r.standard_normal((2, 2, d, 1)).astype(np.float32)
    ref = update_quant_caches_aliased(jk, jv, jnp.asarray(kn), jnp.asarray(vn),
                                      jnp.int32(77), impl="pallas_interpret")

    def port(c):
        vals = torch.from_numpy(np.asarray(c.q.astype(jnp.int8))
                                .transpose(0, 1, 3, 2).copy())
        return quant.QuantCache(quant.pack_int4(vals) if bits == 4 else vals,
                                torch.from_numpy(np.asarray(c.scale)[:, :, 0]
                                                 .copy()), bits)

    pk, pv = port(jk), port(jv)
    decode_cache.write_quant_kv(pk, pv, torch.from_numpy(kn[..., 0]),
                                torch.from_numpy(vn[..., 0]),
                                torch.tensor([77], dtype=torch.int32))
    for got, want in ((pk, port(ref[0])), (pv, port(ref[1]))):
        np.testing.assert_array_equal(got.q.numpy(), want.q.numpy())
        np.testing.assert_array_equal(got.scale.numpy(), want.scale.numpy())


def test_decode_checks_take_the_instantiated_head_dims():
    """The decode kernels are built for D = 32, 64, 128 and 256; any head
    dim up to 256 is taken at the instance that holds it (d 96 over caches
    of 128-value positions), and a head dim above 256 at the least multiple
    of 256 that holds it (d 264 over caches of 512-value positions, taken
    in chunks of 256); a query that does not fit its caches' width raises
    before any launch."""
    idx = torch.zeros(1, dtype=torch.int32)
    for d in quant.DECODE_HEAD_DIMS:
        q = torch.zeros(1, 2, 1, d)
        kc, vc = (quant.QuantCache.empty(1, 2, 16, d, 4) for _ in range(2))
        quant._check(q, kc, vc, idx)
        decode_attention._check(q, FloatCache(torch.zeros(1, 2, 16, d)),
                                FloatCache(torch.zeros(1, 2, 16, d)), idx)
    q = torch.zeros(1, 2, 1, 96)
    kc, vc = (quant.QuantCache.empty(1, 2, 16, 96, 8) for _ in range(2))
    assert kc.q.shape[-1] == 128
    assert quant._check(q, kc, vc, idx) == 128
    decode_attention._check(q, FloatCache(torch.zeros(1, 2, 16, 128)),
                            FloatCache(torch.zeros(1, 2, 16, 128)), idx)
    q = torch.zeros(1, 2, 1, 264)
    with pytest.raises(ValueError, match="cache must be"):
        quant._check(q, kc, vc, idx)
    kc, vc = (quant.QuantCache.empty(1, 2, 16, 264, 8) for _ in range(2))
    assert kc.q.shape[-1] == 512
    assert quant._check(q, kc, vc, idx) == 512
    decode_attention._check(q, FloatCache(torch.zeros(1, 2, 16, 512)),
                            FloatCache(torch.zeros(1, 2, 16, 512)), idx)
    with pytest.raises(ValueError, match="head_dim"):
        quant.check_query(torch.zeros(1, 2, 1, 0))
