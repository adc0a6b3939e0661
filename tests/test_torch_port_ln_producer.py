"""The residual add with LayerNorm statistics (kernel B11) vs the JAX
harness ``benchmarks/ln_producer.py``, on CPU.

``benchmarks/`` is not a package, so the harness is loaded by file path.
B11's twin ``add_stats_plain`` against ``add_stats_pallas(interpret=True)``
at the Pallas kernel's 512-row tile: x bitwise equal (one fp32 add rounded
once, to bf16 or fp32), stats within 1e-6 (fp32 row sums in another
order).  ``AddLNProducerFunction``'s forward and gradients against
autograd of the plain ``add_ln`` (the same recompute: equal to 1e-6) and
against ``jax.vjp`` of the harness's ``_jnp_add_ln`` (1e-5, fp32).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mas_tpu_torch.ops import ln_producer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _harness():
    spec = importlib.util.spec_from_file_location(
        "ln_producer_harness", os.path.join(REPO, "benchmarks",
                                            "ln_producer.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


HARNESS = _harness()


def _inputs(rows, d, seed, dtype=torch.float32):
    r = np.random.default_rng(seed)
    a, b = (r.standard_normal((rows, d)).astype(np.float32) for _ in range(2))
    g = (1 + 0.1 * r.standard_normal(d)).astype(np.float32)
    beta = (0.1 * r.standard_normal(d)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    torch_in = [torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype),
                torch.from_numpy(g), torch.from_numpy(beta)]
    jax_in = [jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt),
              jnp.asarray(g), jnp.asarray(beta)]
    return torch_in, jax_in


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [256, 1024])
def test_add_stats_twin_matches_pallas_interpret(dtype, d):
    (a, b, _, _), (ja, jb, _, _) = _inputs(512, d, seed=d, dtype=dtype)
    jx, jst = HARNESS.add_stats_pallas(ja, jb, interpret=True)
    x, st = ln_producer.add_stats(a, b)
    assert x.dtype == dtype and st.shape == (512, 2)
    np.testing.assert_array_equal(x.float().numpy(),
                                  np.asarray(jx.astype(jnp.float32)))
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=1e-6,
                               rtol=0)


def test_add_stats_takes_any_row_count():
    """37 rows (the Pallas kernel takes multiples of 512): x and the
    LayerNorm it finishes match the harness's unfused ``_jnp_add_ln``."""
    (a, b, g, beta), (ja, jb, jg, jbeta) = _inputs(37, 96, seed=3)
    x, st = ln_producer.add_stats(a, b)
    y = ln_producer.normalize_with(x, st, g, beta, a.dtype)
    jx, jy = HARNESS._jnp_add_ln(ja, jb, jg, jbeta)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)


def test_normalize_with_matches_harness():
    (a, b, g, beta), (ja, jb, jg, jbeta) = _inputs(64, 128, seed=4)
    x, st = ln_producer.add_stats_plain(a, b)
    got = ln_producer.normalize_with(x, st, g, beta, torch.bfloat16)
    ref = HARNESS.normalize_with(jnp.asarray(x.numpy()),
                                 jnp.asarray(st.numpy()), jg, jbeta,
                                 jnp.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_producer_function_forward_and_grads():
    (a, b, g, beta), (ja, jb, jg, jbeta) = _inputs(48, 128, seed=5)
    r = np.random.default_rng(6)
    cx, cy = (r.standard_normal((48, 128)).astype(np.float32)
              for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (a, b, g, beta)]
    x, y = ln_producer.AddLNProducerFunction.apply(*leaves)
    got = torch.autograd.grad((x, y), leaves, (torch.from_numpy(cx),
                                               torch.from_numpy(cy)))
    plain = [t.clone().requires_grad_() for t in (a, b, g, beta)]
    px, py = ln_producer.add_ln_plain(*plain)
    want = torch.autograd.grad((px, py), plain, (torch.from_numpy(cx),
                                                 torch.from_numpy(cy)))
    jout, vjp = jax.vjp(HARNESS._jnp_add_ln, ja, jb, jg, jbeta)
    jgrads = vjp((jnp.asarray(cx), jnp.asarray(cy)))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jout[1]),
                               atol=1e-5)
    for name, gt, w, jw in zip(("a", "b", "g", "beta"), got, want, jgrads):
        np.testing.assert_allclose(gt.numpy(), w.numpy(), atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(gt.numpy(), np.asarray(jw), atol=1e-5,
                                   err_msg=name)


def test_producer_function_grad_of_one_output():
    """Only y used downstream: x's gradient arrives as zeros."""
    (a, b, g, beta), _ = _inputs(16, 64, seed=7)
    leaves = [a.clone().requires_grad_(), b, g, beta]
    _, y = ln_producer.AddLNProducerFunction.apply(*leaves)
    (ga,) = torch.autograd.grad(y.sum(), leaves[:1])
    pa = a.clone().requires_grad_()
    (want,) = torch.autograd.grad(ln_producer.add_ln_plain(pa, b, g,
                                                           beta)[1].sum(),
                                  [pa])
    np.testing.assert_allclose(ga.numpy(), want.numpy(), atol=1e-6)


def test_add_stats_wrapper_on_cpu_and_other_devices():
    before = ln_producer.add_stats.launches
    x = torch.zeros(4, 32)
    ln_producer.add_stats(x, x)
    assert ln_producer.add_stats.launches == before
    m = torch.empty(4, 32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ln_producer.add_stats(m, m)
    with pytest.raises(TypeError, match="one dtype"):
        ln_producer._check(x, x.double())
    with pytest.raises(ValueError, match="one shape"):
        ln_producer._check(x, x[:2])
