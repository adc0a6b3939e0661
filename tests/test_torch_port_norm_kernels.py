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
wrappers hold no Triton kernel of B4, B7 or B8 any more.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mas_tpu.ops.pallas.gn_swish import (_gn_swish_bwd_pallas,
                                         _gn_swish_fwd_stats_pallas)
from mas_tpu.ops.pallas.layer_norm import _ln_bwd_pallas, _ln_fwd_pallas

from mas_tpu_torch.ops import gn_swish, layer_norm


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
