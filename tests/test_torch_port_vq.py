"""The port's VQ encode side and codebook training parts vs the JAX
package, on CPU: k-means, the codebook phase machine, SyncBatchNorm,
Downsample, encode/tokenize, the seg loss, the synthetic seg data and the
``--mode export`` weight bridge.

Inputs are numpy arrays from a seed, weights cross with ``vq_from_flax``.
jax.random and torch draw different numbers from one seed, so every
comparison avoids the draws (counters past the reservoir phase) or feeds
the JAX draw into the port (k-means from JAX's init).  fp32 throughout.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mas_tpu.models import codebook as jcodebook
from mas_tpu.models.layers import Downsample as JDownsample
from mas_tpu.models.layers import SyncBatchNorm as JSyncBatchNorm
from mas_tpu.models.vqvae import VQModel as JVQModel
from mas_tpu.ops.kmeans import kmeans as jkmeans
from mas_tpu.ops.vq import _vq_argmin_pallas, vq_argmin_jnp
from mas_tpu.utils.config import CodebookConfig as JCodebookConfig
from mas_tpu.utils.config import SegLossConfig as JSegLossConfig
from mas_tpu.utils.config import VQModelConfig as JVQModelConfig

from mas_tpu_torch.models import codebook
from mas_tpu_torch.models.layers import Downsample, SyncBatchNorm
from mas_tpu_torch.models.vqvae import VQModel
from mas_tpu_torch.ops import kmeans, vq
from mas_tpu_torch.utils.config import (CodebookConfig, SegLossConfig,
                                        VQModelConfig)
from mas_tpu_torch.utils.weights import (load_reference_pt, serving_state,
                                         vq_from_flax)

CB_TINY = dict(codebook_size=64, codebook_dim=32, reservoir_size=512,
               init_steps=2, samples_per_image=8, kmeans_iters=3)
SEG_TINY = dict(in_channels=159, out_channels=159, channels=(32, 32, 64),
                resolution=32, attn_resolutions=(16,), z_channels=32,
                embed_dim=32, num_res_blocks=1)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def seg_pair(seed=0, embedding=None):
    """(JAX VQModel, its variables, the port VQModel with those weights)
    at the tiny seg size; ``embedding`` replaces the codebook."""
    jcfg = JVQModelConfig(**SEG_TINY, codebook=JCodebookConfig(**CB_TINY))
    jmodel = JVQModel(jcfg)
    variables = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 159))))
    if embedding is not None:
        variables["params"]["codebook_embedding"] = embedding
    model = VQModel(VQModelConfig(**SEG_TINY, codebook=CB_TINY)).eval()
    model.load_state_dict(vq_from_flax(variables, model.cfg), strict=True)
    return jmodel, variables, model


def _seg_batch(seed, b=2, r=32):
    from mas_tpu.data.dataset import SyntheticSegBatches as JSyn

    return next(iter(JSyn(b, r, seed)))["mask"]


# --- k-means -----------------------------------------------------------------

def _clustered(seed, n, d, k):
    r = _rng(seed)
    centers = r.standard_normal((k, d)) * 4
    pts = centers[r.integers(0, k, n)] + r.standard_normal((n, d)) * 0.5
    return pts.astype(np.float32)


@pytest.mark.parametrize("n_valid", [700, 1000])
def test_lloyd_from_jax_init_matches_jax_kmeans(n_valid):
    """kmeans(iters=0) is JAX's init; the port's Lloyd iterations from it
    must give JAX's centroids (fp32, atol 1e-5), with rows past n_valid
    ignored and a chunk (300) that splits the points raggedly."""
    pts = _clustered(n_valid, 1000, 8, 12)
    pts[n_valid:] = 1e3                    # invalid rows far away
    key = jax.random.PRNGKey(3)
    nv = jnp.int32(n_valid)
    init = jkmeans(jnp.asarray(pts), key, 16, iters=0, chunk=256, n_valid=nv)
    ref = jkmeans(jnp.asarray(pts), key, 16, iters=4, chunk=256, n_valid=nv)
    got = kmeans.lloyd(torch.from_numpy(pts), _t(init), 4, n_valid=n_valid,
                       chunk=300)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_kmeans_init_draws_distinct_valid_rows():
    pts = torch.arange(100, dtype=torch.float32)[:, None].repeat(1, 4)
    gen = torch.Generator().manual_seed(0)
    init = kmeans.kmeans_init(pts, gen, 30, n_valid=40)
    rows = init[:, 0].long()
    assert len(set(rows.tolist())) == 30 and int(rows.max()) < 40
    # fewer valid rows than clusters: picks wrap onto the valid rows
    init = kmeans.kmeans_init(pts, gen, 30, n_valid=10)
    assert int(init[:, 0].max()) < 10
    # an empty cluster keeps its centroid
    far = torch.full((1, 4), 1e4)
    out = kmeans.lloyd(pts, torch.cat([pts[:2], far]), 2, n_valid=100)
    assert torch.equal(out[2], far[0])


# --- the codebook phase machine --------------------------------------------

def _jax_quantize(z, emb, counter, cfg, filled=0):
    state = jcodebook.codebook_init_state(cfg).replace(
        counter=jnp.int32(counter), filled=jnp.int32(filled))

    def f(z_, e_):
        z_q, q_loss, idx, st, _, trig = jcodebook.quantize_train(
            z_, e_, state, cfg, jax.random.PRNGKey(0), impl="jnp")
        w = jnp.linspace(-1.0, 1.0, z_q.size).reshape(z_q.shape)
        return jnp.sum(z_q * w) + q_loss, (z_q, q_loss, idx, trig)

    (_, aux), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(z), jnp.asarray(emb))
    return aux, grads


@pytest.mark.parametrize("counter", [0, 4, 60])
def test_quantize_train_matches_jax(counter):
    """With init_steps 2 the micro-step after counter 0 passes through,
    after 4 passes through and collects, after 60 (past q_re_end, so no
    k-means) quantizes and collects: z_q, q_loss, indices and the
    straight-through gradients w.r.t. z and the codebook, fp32 atol
    1e-5."""
    jcfg = JCodebookConfig(**CB_TINY)
    cfg = CodebookConfig(**CB_TINY)
    r = _rng(counter)
    z = r.standard_normal((2, 4, 4, 32)).astype(np.float32)
    emb = r.standard_normal((64, 32)).astype(np.float32)
    (jzq, jq, jidx, jtrig), (jgz, jge) = _jax_quantize(z, emb, counter, jcfg)
    assert not bool(jtrig)
    zt = torch.from_numpy(z).requires_grad_()
    et = torch.from_numpy(emb).requires_grad_()
    state = codebook.codebook_init_state(cfg)
    state.counter = counter
    z_q, q_loss, idx, new, wb, trig = codebook.quantize_train(
        zt, et, state, cfg, torch.Generator().manual_seed(0))
    assert not trig and new.counter == counter + 1
    w = torch.linspace(-1.0, 1.0, z_q.numel()).reshape(z_q.shape)
    gz, ge = torch.autograd.grad((z_q * w).sum() + q_loss, (zt, et),
                                 allow_unused=True)
    ge = torch.zeros_like(et) if ge is None else ge
    np.testing.assert_allclose(z_q.detach().numpy(), np.asarray(jzq),
                               atol=1e-5)
    np.testing.assert_allclose(float(q_loss.detach()), float(jq), atol=1e-5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gz.numpy(), np.asarray(jgz), atol=1e-5)
    np.testing.assert_allclose(ge.numpy(), np.asarray(jge), atol=1e-5)
    assert torch.equal(wb, et.detach())
    if counter + 1 > cfg.q_start_collect:
        assert new.filled == 2 * cfg.samples_per_image
        rows = new.reservoir[:new.filled]
        assert bool((rows[:, None] == zt.detach().reshape(1, -1, 32)).all(
            -1).any(-1).all()), "reservoir rows are latents of z"


def test_bf16_latents_quantize_against_the_bf16_codebook():
    """The codebook is cast to z's dtype before the argmin and the gather
    (``emb_used.astype(z.dtype)`` in JAX): bf16 latents pick and return
    bf16-rounded codes, as JAX's quantize_eval does."""
    r = _rng(14)
    z = r.standard_normal((2, 4, 4, 32)).astype(np.float32)
    emb = r.standard_normal((64, 32)).astype(np.float32)
    zb = torch.from_numpy(z).to(torch.bfloat16)
    z_q, idx = codebook.quantize_eval(zb, torch.from_numpy(emb))
    jzq, jidx = jcodebook.quantize_eval(jnp.asarray(z, jnp.bfloat16),
                                        jnp.asarray(emb), impl="jnp")
    assert z_q.dtype == torch.bfloat16
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(z_q.float().numpy(),
                                  np.asarray(jzq.astype(jnp.float32)))
    assert torch.equal(z_q, torch.from_numpy(emb).to(torch.bfloat16)[
        idx.long()])
    init = codebook.codebook_init_embedding(64, 32,
                                            torch.Generator().manual_seed(0))
    assert float(init.abs().max()) <= 1 / 64 and init.shape == (64, 32)


@pytest.mark.parametrize("d", [320, 512])
def test_vq_argmin_any_code_width_matches_jax(d):
    """C5: the card path's argument check takes code widths above 256,
    and ``vq_argmin`` (its twin on CPU) equals the JAX reference and the
    Pallas kernel in interpret mode exactly, fp32 (random rows: no
    near-ties)."""
    r = np.random.default_rng(d)
    z = r.standard_normal((200, d)).astype(np.float32)
    cb = r.standard_normal((96, d)).astype(np.float32)
    vq._check(torch.from_numpy(z), torch.from_numpy(cb))
    got = vq.vq_argmin(torch.from_numpy(z), torch.from_numpy(cb))
    assert got.dtype == torch.int32 and got.shape == (200,)
    for ref in (vq_argmin_jnp(jnp.asarray(z), jnp.asarray(cb)),
                _vq_argmin_pallas(jnp.asarray(z), jnp.asarray(cb),
                                  interpret=True)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_trigger_schedule_matches_jax():
    """k-means fires at the same counters in both packages, 1..100 with
    init_steps 4 (q_init 12, every 2, until q_re_end 120)."""
    spec = dict(CB_TINY, init_steps=4, reservoir_size=64, codebook_size=4,
                codebook_dim=8, kmeans_iters=1)
    jcfg, cfg = JCodebookConfig(**spec), CodebookConfig(**spec)

    @jax.jit
    def jtrig(counter):
        state = jcodebook.codebook_init_state(jcfg).replace(counter=counter)
        return jcodebook.quantize_train(
            jnp.ones((1, 2, 2, 8)), jnp.ones((4, 8)), state, jcfg,
            jax.random.PRNGKey(0), impl="jnp")[5]

    want = [c + 1 for c in range(100) if bool(jtrig(jnp.int32(c)))]
    got = [c for c in range(1, 101) if codebook.kmeans_due(c, cfg)]
    assert got == want == list(range(12, 101, 2))


def test_kmeans_micro_step_uses_reservoir_centroids():
    cfg = CodebookConfig(**CB_TINY)
    state = codebook.codebook_init_state(cfg)
    state.counter = cfg.q_init - 1
    state.reservoir[:300] = torch.from_numpy(_clustered(1, 300, 32, 64))
    state.filled = 300
    z = torch.randn(2, 4, 4, 32, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    emb = torch.zeros(64, 32, requires_grad=True)
    z_q, q_loss, idx, new, wb, trig = codebook.quantize_train(
        z, emb, state, cfg, torch.Generator().manual_seed(2))
    assert trig and new.counter == cfg.q_init and not wb.requires_grad
    assert new.filled == 300 + 2 * cfg.samples_per_image
    # straight-through: z + (z_q - z) is z_q up to one rounding
    torch.testing.assert_close(z_q.detach(), wb[idx.long()], atol=1e-6,
                               rtol=0)
    assert float(wb.abs().max()) > 1.0          # centroids, not the zeros
    assert torch.autograd.grad(q_loss, emb, allow_unused=True)[0] is None


# --- layers -------------------------------------------------------------------

def test_sync_batchnorm_matches_jax_train_and_eval():
    """Biased batch variance, decay 0.9 running stats (fp32, 1e-5)."""
    r = _rng(4)
    x = (r.standard_normal((3, 5, 4, 16)) * 2 + 1).astype(np.float32)
    jbn = JSyncBatchNorm()
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    scale = r.standard_normal(16).astype(np.float32)
    bias = r.standard_normal(16).astype(np.float32)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": variables["batch_stats"]}
    y, upd = jbn.apply(variables, jnp.asarray(x), use_running_average=False,
                       mutable=["batch_stats"])
    bn = SyncBatchNorm(16)
    with torch.no_grad():
        bn.weight.copy_(_t(scale))
        bn.bias.copy_(_t(bias))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = bn(xt, train=True).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), atol=1e-5)
    stats = upd["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), atol=1e-6)
    # biased: var of the batch, not var * n / (n - 1)
    want_var = 0.9 + 0.1 * x.reshape(-1, 16).var(axis=0)
    np.testing.assert_allclose(bn.running_var.numpy(), want_var, atol=1e-5)
    y_eval = jbn.apply({**variables, "batch_stats": stats}, jnp.asarray(x))
    np.testing.assert_allclose(bn(xt).permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(y_eval), atol=1e-5)


@pytest.mark.parametrize("size", [8, 7])
def test_downsample_pads_bottom_right_like_jax(size):
    r = _rng(size)
    x = r.standard_normal((2, size, size, 8)).astype(np.float32)
    jds = JDownsample()
    variables = jax.tree.map(np.asarray, jds.init(jax.random.PRNGKey(1),
                                                  jnp.asarray(x)))
    ref = jds.apply(variables, jnp.asarray(x))
    ds = Downsample(8)
    kernel = variables["params"]["conv"]["kernel"]
    with torch.no_grad():
        ds.conv.weight.copy_(_t(kernel.transpose(3, 2, 0, 1)))
        ds.conv.bias.copy_(_t(variables["params"]["conv"]["bias"]))
    got = ds(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == ref.shape == (2, size // 2, size // 2, 8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-5)


def test_resnet_dropout_only_in_training():
    from mas_tpu_torch.models.layers import ResnetBlock

    block = ResnetBlock(32, 32, dropout=0.5)
    x = torch.randn(1, 32, 4, 4)
    block.eval()
    assert torch.equal(block(x), block(x))
    block.train()
    assert not torch.equal(block(x), block(x))


# --- encode side -------------------------------------------------------------

def test_encode_latent_and_tokens_match_jax():
    """Eval encode (running-stat BN): latents fp32 atol 1e-4 (tens of
    convs summed in another order), tokens under the B5 agreement rule;
    train-mode encode updates the BN running stats as JAX does."""
    emb = _rng(5).standard_normal((64, 32)).astype(np.float32)
    jmodel, variables, model = seg_pair(seed=1, embedding=emb)
    x = _seg_batch(7)
    ref_z = jmodel.apply(variables, jnp.asarray(x),
                         method=JVQModel.encode_latent)
    ref_idx = jmodel.apply(variables, jnp.asarray(x),
                           method=JVQModel.encode_tokens)
    with torch.no_grad():
        z = model.encode_latent(torch.from_numpy(x))
        idx = model.encode_tokens(torch.from_numpy(x))
    assert z.shape == (2, 16, 16, 32) and idx.shape == (2, 16, 16)
    np.testing.assert_allclose(z.numpy(), np.asarray(ref_z), atol=1e-4)
    assert vq.argmin_agrees(z.reshape(-1, 32), torch.from_numpy(emb),
                            idx.reshape(-1), _t(ref_idx).reshape(-1))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    ref_zt, upd = jmodel.apply(variables, jnp.asarray(x), train=True,
                               method=JVQModel.encode_latent,
                               mutable=["batch_stats"])
    with torch.no_grad():
        zt = model.encode_latent(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(zt.numpy(), np.asarray(ref_zt), atol=1e-4)
    np.testing.assert_allclose(
        model.quant_conv[1].running_var.numpy(),
        np.asarray(upd["batch_stats"]["quant_bn"]["var"]), atol=1e-5)


def test_eval_forward_and_reconstruct_match_jax():
    emb = _rng(6).standard_normal((64, 32)).astype(np.float32)
    jmodel, variables, model = seg_pair(seed=2, embedding=emb)
    x = _seg_batch(8)
    ref, ref_q = jmodel.apply(variables, jnp.asarray(x))
    ref_pass = jmodel.apply(variables, jnp.asarray(x), quantize=False,
                            method=JVQModel.reconstruct)
    with torch.no_grad():
        got, q = model(torch.from_numpy(x))
        got_pass = model.reconstruct(torch.from_numpy(x), quantize=False)
    assert got.shape == (2, 32, 32, 159) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(float(q), float(ref_q), rtol=1e-5)
    np.testing.assert_allclose(got_pass.numpy(), np.asarray(ref_pass),
                               atol=1e-4)


# --- loss and data -------------------------------------------------------------

def test_bce_loss_with_quant_matches_jax():
    from mas_tpu.losses.seg import bce_loss_with_quant as jloss

    from mas_tpu_torch.losses.seg import bce_loss_with_quant, pos_weight

    r = _rng(9)
    logits = (r.standard_normal((2, 4, 4, 159)) * 3).astype(np.float32)
    targets = _seg_batch(9, r=4)
    spec = dict(codebook_weight=0.5, face_weight=20.0)
    ref = jloss(jnp.float32(0.3), jnp.asarray(targets), jnp.asarray(logits),
                JSegLossConfig(**spec))
    got = bce_loss_with_quant(torch.tensor(0.3), torch.from_numpy(targets),
                              torch.from_numpy(logits), SegLossConfig(**spec))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    w = pos_weight(SegLossConfig())
    assert float(w[152]) == 1.0 and float(w[153]) == float(w[157]) == 20.0
    assert float(w[158]) == 1.0


def test_synthetic_seg_batches_and_packed_one_hot_match_jax():
    from mas_tpu.data.dataset import SyntheticSegBatches as JSyn
    from mas_tpu.data.segmap import one_hot_seg_packed as jone_hot
    from mas_tpu.data.segmap import pack_seg_labels

    from mas_tpu_torch.data.dataset import SyntheticSegBatches
    from mas_tpu_torch.data.segmap import one_hot_seg_packed

    ours, theirs = iter(SyntheticSegBatches(2, 16, 4)), iter(JSyn(2, 16, 4))
    for _ in range(2):
        a, b = next(ours)["mask"], next(theirs)["mask"]
        assert a.dtype == np.float32 and a.shape == (2, 16, 16, 159)
        np.testing.assert_array_equal(a, b)
    r = _rng(10)
    packed = np.stack([pack_seg_labels(r.integers(-1, 133, (8, 8)),
                                       r.integers(0, 3, (8, 8)),
                                       r.integers(-1, 20, (8, 8)),
                                       r.integers(0, 6, (8, 8)))
                       for _ in range(2)])
    got = one_hot_seg_packed(torch.from_numpy(packed))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jone_hot(jnp.asarray(packed))))


# --- weights ---------------------------------------------------------------

def test_jax_export_mode_pt_loads_strict_into_full_vq(tmp_path):
    """A .pt written by the JAX package's export mode (random init from
    PRNGKey(0)) loads with strict=True into the full port VQModel, which
    then encodes and decodes as the JAX model does (atol 1e-4)."""
    from mas_tpu.cli import _load_vq, _run_export
    from mas_tpu.utils.config import TrainConfig as JTrainConfig

    raw = {"model": dict(SEG_TINY, codebook=CB_TINY),
           "output": str(tmp_path / "vq.pt")}
    path = _run_export(json.loads(json.dumps(raw)), JTrainConfig())
    model = VQModel(VQModelConfig(**SEG_TINY, codebook=CB_TINY)).eval()
    state = serving_state(load_reference_pt(path), "vq")
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state, strict=True)
    jmodel, variables = _load_vq(raw["model"], None)
    x = _seg_batch(11)
    ref = jmodel.apply(variables, jnp.asarray(x),
                       method=JVQModel.encode_latent)
    with torch.no_grad():
        got = model.encode_latent(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
