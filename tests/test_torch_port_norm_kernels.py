"""The host side of kernels B7 (LayerNorm, ``csrc/layer_norm.cu``), B4 and
B8 (GroupNorm+swish forward and backward, ``csrc/gn_swish_fwd.cu``,
``csrc/gn_swish_bwd.cu``), on CPU.

The kernels run only on the card (``chip_smoke.py`` holds them against
their twins there, at the same widths as below).  Held here: the twins,
which the wrappers take on CPU, against the JAX package's Pallas kernels
in interpret mode at the widths whose code paths differ in the kernels
(B7: odd d, d even but not a multiple of 4, one warp a row, several warps
a row; B4/B8: any C that the groups divide, powers of two or not, and any
number of groups), that the card path's argument checks take those C,
that CPU calls take the plain twins and count no launch, and that the
wrappers hold no Triton kernel of B4, B7 or B8 any more.  Also the
LayerNorm's route (``ops/norms.py::ln_route``): B7's forward for every
call on the card with autograd off, the old rule elsewhere, CPU calls
unchanged, the twin within a bf16 step of the upcast chain it replaces,
and every LayerNorm of a guided pass counted on the B7 route.
"""

import inspect
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mas_tpu.ops.pallas.gn_swish import (_gn_swish_bwd_pallas,
                                         _gn_swish_fwd_stats_pallas)
from mas_tpu.ops.pallas.layer_norm import _ln_bwd_pallas, _ln_fwd_pallas

from mas_tpu_torch.ops import gn_swish, layer_norm, norms


@pytest.mark.parametrize("d", [37, 64, 100, 1001, 1002, 4096])
def test_layer_norm_twins_match_pallas_at_the_kernel_widths(d):
    """B7's twins (the wrappers on CPU) vs the Pallas forward and backward
    in interpret mode, 64 rows of fp32.  y and dx: atol 1e-5 (fp32, the
    row sums in another order); dscale and dbias sum 64 rows: atol 1e-4."""
    r = np.random.default_rng(d)
    x = (r.standard_normal((64, d)) * 2 + 0.5).astype(np.float32)
    g = r.standard_normal((64, d)).astype(np.float32)
    s = (r.standard_normal(d) * 0.5 + 1.0).astype(np.float32)
    b = (r.standard_normal(d) * 0.1).astype(np.float32)
    t = torch.from_numpy
    y = layer_norm.layer_norm_fwd(t(x), t(s), t(b))
    got = layer_norm.layer_norm_bwd(t(x), t(g), t(s))
    j = jnp.asarray
    np.testing.assert_allclose(
        y.numpy(), np.asarray(_ln_fwd_pallas(j(x), j(s), j(b), 1e-5,
                                             interpret=True)), atol=1e-5)
    ref = _ln_bwd_pallas(j(x), j(g), j(s), 1e-5, interpret=True)
    for a, w, tol in zip(got, ref, (1e-5, 1e-4, 1e-4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=tol)


@pytest.mark.parametrize("c,groups", [(8, 2), (256, 256), (512, 4),
                                      (4096, 32), (8192, 4)])
def test_gn_swish_bwd_twin_matches_pallas_at_any_channels_and_groups(
        c, groups):
    """B8's twin (the wrapper on CPU) vs the Pallas backward in interpret
    mode, from each side's own forward stats, at channel and group counts
    the kernel takes on the card since its S1/S2 sums stopped staging a
    whole image's channels: [1, 2, 4, C] fp32.  dx: atol 2e-5; dscale and
    dbias: atol 1e-4, as the [B, H, W, 64/128] test of the ops file."""
    r = np.random.default_rng(c + groups)
    shape = (1, 2, 4, c)
    x = r.standard_normal(shape).astype(np.float32)
    g = r.standard_normal(shape).astype(np.float32)
    s = (r.standard_normal(c) * 0.5 + 1.0).astype(np.float32)
    b = (r.standard_normal(c) * 0.1).astype(np.float32)
    t, j = torch.from_numpy, jnp.asarray
    _, stats = gn_swish.gn_swish(t(x), t(s), t(b), groups)
    got = gn_swish.gn_swish_bwd(t(x), t(g), t(s), t(b), stats, groups)
    _, jstats = _gn_swish_fwd_stats_pallas(j(x), j(s), j(b), groups, 1e-6,
                                           interpret=True)
    ref = _gn_swish_bwd_pallas(j(x), j(g), j(s), j(b), jstats, groups,
                               interpret=True)
    for a, w, tol in zip(got, ref, (2e-5, 1e-4, 1e-4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=tol)


def test_cpu_calls_take_the_twins_and_count_no_launch():
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.standard_normal((96, 128)).astype(np.float32))
    g = torch.from_numpy(r.standard_normal((96, 128)).astype(np.float32))
    s, b = torch.ones(128), torch.zeros(128)
    counts = (layer_norm.layer_norm_fwd.launches,
              layer_norm.layer_norm_bwd.launches,
              gn_swish.gn_swish_bwd.launches)
    y = layer_norm.layer_norm_fwd(x, s, b)
    dx, dscale, dbias = layer_norm.layer_norm_bwd(x, g, s)
    xn = x.reshape(2, 6, 8, 128)
    gn = g.reshape(2, 6, 8, 128)
    _, stats = gn_swish.gn_swish(xn, s, b)
    got = gn_swish.gn_swish_bwd(xn, gn, s, b, stats)
    want = gn_swish.gn_swish_bwd_plain(xn, gn, s, b, stats)
    assert counts == (layer_norm.layer_norm_fwd.launches,
                      layer_norm.layer_norm_bwd.launches,
                      gn_swish.gn_swish_bwd.launches)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    ref = _ln_fwd_pallas(jnp.asarray(x.numpy()), jnp.ones(128),
                         jnp.zeros(128), 1e-5, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=1e-5)
    assert dx.shape == x.shape and dscale.shape == dbias.shape == (128,)


@pytest.mark.parametrize("module,symbol,gone", [
    (layer_norm, "mas_layer_norm_bwd", "triton"),
    (gn_swish, "mas_gn_swish_bwd", "_gn_bwd_"),
    (gn_swish, "mas_gn_swish_fwd", "triton"),
], ids=["B7", "B8", "B4"])
def test_b7_and_b8_kernels_are_cuda_not_triton(module, symbol, gone):
    """Each kernel's module names its ctypes symbol and keeps none of the
    Triton code it replaced: no Triton in B7's module, B8's Triton kernels
    gone, and, since B4 is CUDA C++ too, no Triton in the GroupNorm
    module."""
    src = inspect.getsource(module)
    assert gone not in src and symbol in src


@pytest.mark.parametrize("c", [96, 192, 384])
def test_gn_swish_any_channels_check_and_twins_match_pallas(c):
    """C4: the card path's argument checks (``_check`` for B4, through
    ``_check_bwd`` for B8) take any C that the 32 groups divide, powers of
    two or not, and B4's and B8's twins (the wrappers on CPU) match the
    Pallas forward and backward in interpret mode on [1, 4, 4, C] fp32:
    y, stats and dx atol 1e-5 (fp32, sums in another order); dscale and
    dbias atol 1e-4 (sums of 16 rows), as the other GroupNorm tests."""
    r = np.random.default_rng(c)
    shape = (1, 4, 4, c)
    x = (r.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    g = r.standard_normal(shape).astype(np.float32)
    s = (r.standard_normal(c) * 0.5 + 1.0).astype(np.float32)
    b = (r.standard_normal(c) * 0.1).astype(np.float32)
    t, j = torch.from_numpy, jnp.asarray
    gn_swish._check(t(x), t(s), t(b), 32)
    y, stats = gn_swish.gn_swish(t(x), t(s), t(b), 32)
    gn_swish._check_bwd(t(x), t(g), t(s), t(b), stats, 32)
    got = gn_swish.gn_swish_bwd(t(x), t(g), t(s), t(b), stats, 32)
    jy, jstats = _gn_swish_fwd_stats_pallas(j(x), j(s), j(b), 32, 1e-6,
                                            interpret=True)
    ref = _gn_swish_bwd_pallas(j(x), j(g), j(s), j(b), jstats, 32,
                               interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(stats.numpy(), np.asarray(jstats), atol=1e-5)
    for a, w, tol in zip(got, ref, (1e-5, 1e-4, 1e-4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=tol)


# --- the LayerNorm's route (``ops/norms.py::ln_route``) ---------------------

def _bf16_steps(a: torch.Tensor, b: torch.Tensor) -> float:
    """The widest gap between two bf16 tensors in bf16 steps (ulps) at the
    larger value's magnitude, counted from 2^-7 up: where x^ w + b cancels
    to a value far under the row's terms, the fp32 sums' order decides
    its low bits."""
    a, b = a.float(), b.float()
    mag = torch.maximum(torch.maximum(a.abs(), b.abs()),
                        torch.tensor(2.0 ** -7))
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((a - b).abs() / ulp).max())


def _ln_bf16(shape, seed):
    r = np.random.default_rng(seed)
    d = shape[-1]
    x = torch.from_numpy((r.standard_normal(shape) * 2 + 0.5)
                         .astype(np.float32)).to(torch.bfloat16)
    s = torch.from_numpy((r.standard_normal(d) * 0.5 + 1.0)
                         .astype(np.float32))
    b = torch.from_numpy((r.standard_normal(d) * 0.1).astype(np.float32))
    return x, s, b


def _upcast(x, s, b):
    """The three-launch chain: fp32 upcast, fp32 layer norm, one rounding."""
    return torch.nn.functional.layer_norm(x.float(), x.shape[-1:], s, b,
                                          1e-5).to(x.dtype)


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("rows", [128, 768])
def test_cpu_layer_norm_without_grad_keeps_the_upcast_chain(rows, impl):
    """A decode step's [rows, 1, 1024] bf16 LayerNorm on the CPU under
    ``no_grad`` takes the upcast chain, for either ``impl``, and returns
    its bits: CPU calls keep the path they had."""
    x, s, b = _ln_bf16((rows, 1, 1024), rows)
    before = dict(norms.layer_norm.calls)
    with torch.no_grad():
        got = norms.layer_norm(x, s, b, impl=impl)
    assert torch.equal(got, _upcast(x, s, b))
    after = norms.layer_norm.calls
    assert {k: after[k] - before[k] for k in after} == dict(b7=0, upcast=1)


@pytest.mark.parametrize("rows", [128, 768, 3000])
def test_b7_twin_within_one_ulp_of_the_upcast_chain(rows):
    """B7's plain twin (fp32 two-pass statistics and affine, one rounding)
    against the chain it replaces on the card (ATen's fp32 statistics,
    one rounding) at the decode and prefill width d 1024, bf16: the fp32
    values differ only in summation order, so each rounded value lies
    within one bf16 step of the other (counted as ``_bf16_steps``)."""
    x, s, b = _ln_bf16((rows, 1024), rows + 1)
    assert _bf16_steps(layer_norm.layer_norm_fwd_plain(x, s, b),
                       _upcast(x, s, b)) <= 1


_BF, _F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("device,grad,impl,shape,dtype,route", [
    # the card without autograd: B7's forward at any row count
    ("cuda", False, "jnp", (768, 1, 1024), _BF, "b7"),
    ("cuda", False, "pallas", (128, 1, 1024), _BF, "b7"),
    ("cuda", False, "jnp", (768, 384, 1024), _BF, "b7"),
    ("cuda", False, "jnp", (4, 1, 1000), _F32, "b7"),
    ("cuda", False, "jnp", (1024,), _BF, "b7"),
    # ... in the dtypes and widths B7 takes
    ("cuda", False, "jnp", (8, 1, 1024), torch.float16, "upcast"),
    ("cuda", False, "jnp", (8, 1, 16384), _BF, "upcast"),
    # autograd on: the rule of the training step
    ("cuda", True, "jnp", (8, 1408, 1024), _BF, "upcast"),
    ("cuda", True, "pallas", (8, 1408, 1024), _BF, "b7"),
    ("cuda", True, "pallas", (768, 1, 1024), _BF, "upcast"),
    ("cuda", True, "pallas", (4096, 96), _F32, "upcast"),
    # the CPU: the path it had, grad or not
    ("cpu", False, "jnp", (768, 1, 1024), _BF, "upcast"),
    ("cpu", False, "pallas", (768, 1, 1024), _BF, "upcast"),
    ("cpu", False, "pallas", (8, 1408, 1024), _BF, "b7"),
    ("cpu", True, "pallas", (2, 2048, 128), _F32, "b7"),
    ("cpu", True, "jnp", (2, 2048, 128), _F32, "upcast"),
])
def test_ln_route(device, grad, impl, shape, dtype, route):
    assert norms.ln_route(device, grad, impl, shape, dtype) == route


@pytest.mark.parametrize("sliced", [False, True], ids=["rows", "last_pos"])
def test_b7_route_is_one_forward_over_the_rows(sliced):
    """The ``"b7"`` route (taken here on CPU tensors by a route rule that
    reads them as the card's) runs ``LayerNormFunction``, whose forward
    calls ``layer_norm_fwd`` once over the rows as contiguous [N, d], also
    for the prefill's last position ``h[:, -1:]`` (not contiguous), and
    gives x's shape back: the twin's bits, and the call counted under
    "b7"."""
    x, s, b = _ln_bf16((6, 5, 256), 7)
    if sliced:
        x = x[:, -1:]
    real = norms.ln_route
    as_card = lambda _dev, *rest: real("cuda", *rest)
    before = dict(norms.layer_norm.calls)
    with mock.patch.object(norms, "ln_route", as_card), \
            mock.patch.object(layer_norm, "layer_norm_fwd",
                              wraps=layer_norm.layer_norm_fwd) as fwd, \
            torch.no_grad():
        got = norms.layer_norm(x, s, b)
    rows = fwd.call_args.args[0]
    assert fwd.call_count == 1 and rows.shape == (x.numel() // 256, 256)
    assert rows.is_contiguous()
    want = layer_norm.layer_norm_fwd_plain(x.reshape(-1, 256), s, b)
    assert got.shape == x.shape and torch.equal(got.reshape(-1, 256), want)
    assert norms.layer_norm.calls["b7"] == before["b7"] + 1


def test_every_layer_norm_of_a_guided_pass_takes_b7_without_grad():
    """A sandwich-norm MakeAScene (2 layers, bf16) under inference mode,
    with the route rule reading its CPU tensors as the card's: the
    prefill's 4 x 2 + 2 LayerNorms and each decode step's 4 x 2 + 2 take
    the "b7" route and none the upcast chain, and the logits stay within
    bf16 rounding of the upcast chain's (each LN's output within an ulp,
    carried through 2 layers)."""
    from mas_tpu_torch.models.transformer import MakeAScene
    from mas_tpu_torch.utils.config import TransformerConfig

    torch.manual_seed(24)
    cfg = TransformerConfig(
        num_layers=2, hidden_dim=128, num_attn_heads=2, image_vocab_size=96,
        seg_vocab_size=32, text_vocab_size=88, image_tokens_per_dim=4,
        seg_tokens_per_dim=4, text_length=16, compute_dtype="bfloat16",
        cogview_sandwich_layernorm=True, kv_cache_dtype="int4")
    model = MakeAScene(cfg).eval()
    r = np.random.default_rng(24)
    text = torch.from_numpy(r.integers(1, 60, (2, 16)))
    seg = torch.from_numpy(r.integers(0, 32, (2, 16)))
    tok = torch.from_numpy(r.integers(0, 96, (2, 1)))
    per_pass = 4 * cfg.num_layers + 2

    def run(counts):
        out = []
        with torch.inference_mode():
            before = dict(norms.layer_norm.calls)
            logits, kvs = model.prefill(text, seg)
            counts.append({k: norms.layer_norm.calls[k] - before[k]
                           for k in before})
            out.append(logits)
            caches = model.allocate_caches(kvs, 2)
            for step in range(2):
                before = dict(norms.layer_norm.calls)
                out.append(model.decode_step(tok, step, caches))
                counts.append({k: norms.layer_norm.calls[k] - before[k]
                               for k in before})
        return torch.stack(out)

    real = norms.ln_route
    as_card = lambda _dev, *rest: real("cuda", *rest)
    chain_counts, b7_counts = [], []
    chain = run(chain_counts)
    with mock.patch.object(norms, "ln_route", as_card):
        b7 = run(b7_counts)
    assert chain_counts == [dict(b7=0, upcast=per_pass)] * 3
    assert b7_counts == [dict(b7=per_pass, upcast=0)] * 3
    scale = float(chain.abs().max())
    assert float((b7 - chain).abs().max()) <= 0.05 * scale
