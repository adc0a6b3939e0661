"""The port's VQ-IMG (VQGAN) training vs the JAX package, on CPU: the
fp32-master VQ model and its decoder split, the synthetic image batches,
the generator loss with its adaptive GAN weight, one whole dual-optimizer
step against ``mas_tpu/train/steps.py::make_img_train_step``, the frozen
towers from torch checkpoints, checkpoints and ``--mode pretrain_image``.

Tiny sizes: the VQ model of ``tests/test_img_train_step.py`` (32^2 RGB,
channels (32, 32, 64), attention at 8), a discriminator of 8 base filters,
LPIPS at its full VGG16 widths, FaceNet with one block per stage.  Weights
are the JAX towers' own, crossed by ``utils/weights.py``; fp32 unless a
test says otherwise.
"""

import dataclasses
import importlib
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mas_tpu.data.dataset import SyntheticImgBatches as JSyntheticImgBatches
from mas_tpu.losses import vqgan as jvqgan
from mas_tpu.losses.discriminator import PatchDiscriminator as JDisc
from mas_tpu.losses.lpips import LPIPS as JLPIPS
from mas_tpu.models.vqvae import VQModel as JVQModel
from mas_tpu.train.state import create_vq_train_state as jcreate_state
from mas_tpu.train.state import make_adam as jmake_adam
from mas_tpu.train.steps import make_img_train_step as jmake_step
from mas_tpu.utils.config import CodebookConfig as JCodebookConfig
from mas_tpu.utils.config import OptimizerConfig as JOptimizerConfig
from mas_tpu.utils.config import VQGANLossConfig as JVQGANLossConfig
from mas_tpu.utils.config import VQModelConfig as JVQModelConfig

from mas_tpu_torch.data.dataset import SyntheticImgBatches
from mas_tpu_torch.losses import vqgan
from mas_tpu_torch.losses.discriminator import PatchDiscriminator
from mas_tpu_torch.losses.face_loss import FaceNet
from mas_tpu_torch.losses.lpips import LPIPS
from mas_tpu_torch.models.codebook import CodebookState
from mas_tpu_torch.models.vqvae import VQModel
from mas_tpu_torch.train.state import VQTrainState, make_adam
from mas_tpu_torch.train.steps import make_img_train_step
from mas_tpu_torch.utils import checkpoint
from mas_tpu_torch.utils.config import (OptimizerConfig, TrainConfig,
                                        VQGANLossConfig, VQModelConfig)
from mas_tpu_torch.utils.weights import (disc_from_flax, face_from_flax,
                                         lpips_from_flax, vq_from_flax)

jface = importlib.import_module("mas_tpu.losses.face_loss")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CB = dict(codebook_size=16, codebook_dim=32, init_steps=2,
          reservoir_size=64, samples_per_image=4)
IMG_TINY = dict(in_channels=3, out_channels=3, resolution=32,
                channels=(32, 32, 64), attn_resolutions=(8,), z_channels=32,
                embed_dim=32)
# Adam's eps 1e-3 keeps updates of the gradients that are zero up to
# rounding (the conv bias ahead of the BN) out of the comparison, as in
# tests/test_torch_port_train.py
OPT = dict(lr=1e-3, eps=1e-3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _stats(stats, seed):
    r = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (r.uniform(0.5, 1.5, a.shape) if a.ndim and a.min() == 1
                   else r.normal(0, 0.1, a.shape)).astype(np.float32),
        _np(stats))


def _jax_towers():
    """(JAX LPIPS, its variables, JAX FaceNet (1, 1, 1, 1), its variables
    with numpy BN statistics) and the port's towers on those weights."""
    x = jnp.zeros((1, 32, 32, 3))
    jlp = JLPIPS()
    lp_vars = _np(jlp.init(jax.random.PRNGKey(1), x, x))
    jfn = jface.FaceNet(layers=(1, 1, 1, 1))
    fn_vars = _np(jfn.init(jax.random.PRNGKey(2), jnp.zeros((1, 64, 64, 3))))
    fn_vars["batch_stats"] = _stats(fn_vars["batch_stats"], 3)
    lp = LPIPS()
    lp.load_state_dict(lpips_from_flax(lp_vars), strict=True)
    fn = FaceNet(layers=(1, 1, 1, 1))
    fn.load_state_dict(face_from_flax(fn_vars), strict=True)
    return (jlp, lp_vars, jfn, fn_vars, lp.eval().requires_grad_(False),
            fn.eval().requires_grad_(False))


def _batch(seed=0):
    b = next(iter(JSyntheticImgBatches(2, 32, max_boxes=2, seed=seed)))
    assert b["bbox_face"].any()
    return b


def _vq_pair(dtype="float32"):
    """(JAX model, variables with a numpy codebook, port model with
    fp32 parameters on those weights)."""
    jcfg = JVQModelConfig(**IMG_TINY, codebook=JCodebookConfig(**CB))
    jmodel = JVQModel(jcfg)
    variables = _np(jmodel.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 32, 32, 3))))
    variables["params"]["codebook_embedding"] = np.random.default_rng(
        0).standard_normal((16, 32)).astype(np.float32)
    cfg = VQModelConfig(**IMG_TINY, codebook=CB, compute_dtype=dtype)
    model = VQModel(cfg, fp32_params=True)
    model.load_state_dict(vq_from_flax(variables, cfg), strict=True)
    return jmodel, variables, model


def test_synthetic_img_batches_match_jax():
    """The same numpy draws: two batches equal, boxes inside the image."""
    mine, ref = (iter(cls(2, 64, seed=5)) for cls in
                 (SyntheticImgBatches, JSyntheticImgBatches))
    for _ in range(2):
        a, b = next(mine), next(ref)
        assert set(a) == set(b) == {"image", "bbox_obj", "bbox_face"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        assert a["bbox_obj"].max() <= 64


def test_fp32_params_model_computes_like_the_serving_model():
    """A bf16 model with fp32 master weights holds fp32 conv weights and
    reconstructs bitwise as the bf16 serving model on the same weights
    (the cast at use gives the same bf16 weights); ``decode_trunk`` then
    ``decode_final`` equals ``decode_latent``."""
    _, variables, master = _vq_pair("bfloat16")
    serving = VQModel(master.cfg)
    serving.load_state_dict(vq_from_flax(variables, master.cfg), strict=True)
    assert master.last_layer.dtype == torch.float32
    assert serving.last_layer.dtype == torch.bfloat16
    x = torch.from_numpy(np.random.default_rng(1).random((1, 16, 16, 3),
                                                        np.float32))
    with torch.no_grad():
        a = master.reconstruct(x, quantize=False)
        b = serving.reconstruct(x, quantize=False)
        z = master.encode_latent(x)
        split = master.decode_final(master.decode_trunk(z))
    assert torch.equal(a, b)
    assert torch.equal(split, master.decode_latent(z))


def test_decode_trunk_and_final_match_jax():
    """fp32: ``decode_trunk`` (NHWC, before the final conv) and
    ``decode_final`` against the JAX methods, atol 1e-5."""
    jmodel, variables, model = _vq_pair()
    z = np.random.default_rng(2).normal(size=(2, 16, 16, 32)).astype(
        np.float32)
    jh = jmodel.apply(variables, jnp.asarray(z), method=JVQModel.decode_trunk)
    jr = jmodel.apply(variables, jh, method=JVQModel.decode_final)
    with torch.no_grad():
        h = model.decode_trunk(torch.from_numpy(z))
        r = model.decode_final(h)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-5)


def test_generator_loss_and_d_weight_match_jax():
    """disc_start 0, the face term on: nll, g, face loss, the adaptive
    d_weight (two gradients w.r.t. the final conv weight) and the total
    against JAX's ``generator_step_loss`` on one decoder trunk output,
    rtol 1e-4 (the gradient norms sum in another order)."""
    jmodel, variables, model = _vq_pair()
    jlp, lp_vars, jfn, fn_vars, lp, fn = _jax_towers()
    jd = JDisc(base_filters=8)
    d_vars = _np(jd.init(jax.random.PRNGKey(4), jnp.zeros((1, 32, 32, 3))))
    disc = PatchDiscriminator(base_filters=8)
    disc.load_state_dict(disc_from_flax(d_vars), strict=True)
    b = _batch(1)
    z = np.random.default_rng(3).normal(size=(2, 16, 16, 32)).astype(
        np.float32)
    q_loss = np.float32(0.37)
    cfg = dict(disc_start=0, face_loss=True)
    params = variables["params"]

    def apply_final(kernel, h):
        p2 = dict(params)
        p2["decoder"] = dict(params["decoder"])
        p2["decoder"]["conv_out"] = {**params["decoder"]["conv_out"],
                                     "kernel": kernel}
        return jmodel.apply({"params": p2}, h, method=JVQModel.decode_final)

    def jdisc_fwd(x):
        return jd.apply(d_vars, x, train=True, mutable=["batch_stats"])[0]

    # JAX decodes the port's trunk: the gradients w.r.t. the final conv
    # pass VGG16's ReLUs, and a recon that differs by the trunk's fp32
    # rounding (~4e-6) flips the pre-activations within that of zero, which
    # moved d_weight by 1e-4 relative when each package decoded z itself
    h = model.decode_trunk(torch.from_numpy(z))
    trunk = jnp.asarray(h.detach().numpy())
    recon = jmodel.apply(variables, trunk, method=JVQModel.decode_final)
    fns = jvqgan.PerceptualFns(
        lpips=lambda r, f: jlp.apply(lp_vars, r, f), disc=jdisc_fwd,
        facenet=lambda x: jfn.apply(fn_vars, x))
    want = jax.jit(lambda *a: jvqgan.generator_step_loss(
        fns, JVQGANLossConfig(**cfg), *a, apply_final))(
        jnp.asarray(b["image"]), recon, jnp.asarray(q_loss), jnp.int32(0),
        jnp.asarray(b["bbox_obj"]), jnp.asarray(b["bbox_face"]), trunk,
        params["decoder"]["conv_out"]["kernel"])

    r = model.decode_final(h)
    got = vqgan.generator_step_loss(
        vqgan.PerceptualFns(
            lpips=lp, disc=lambda x: disc(x, train=True, update_stats=False),
            facenet=fn),
        VQGANLossConfig(**cfg), torch.from_numpy(b["image"]), r,
        torch.tensor(q_loss), 0, torch.from_numpy(b["bbox_obj"]),
        torch.from_numpy(b["bbox_face"]), model.last_layer)
    for k in ("loss", "nll_loss", "g_loss", "face_loss", "d_weight",
              "disc_factor"):
        np.testing.assert_allclose(float(torch.as_tensor(got[k]).detach()),
                                   float(want[k]), rtol=1e-4, err_msg=k)
    assert got["loss"].requires_grad and not got["d_weight"].requires_grad
    assert float(got["face_loss"]) > 0 and float(got["d_weight"]) > 0


def _port_state(variables, d_vars, counter, lp, fn, opt=OPT):
    jmodel_cfg = VQModelConfig(**IMG_TINY, codebook=CB)
    model = VQModel(jmodel_cfg, fp32_params=True)
    model.load_state_dict(vq_from_flax(variables, jmodel_cfg), strict=True)
    disc = PatchDiscriminator(base_filters=8)
    disc.load_state_dict(disc_from_flax(d_vars), strict=True)
    spec = OptimizerConfig(**opt)
    state = VQTrainState(
        0, model,
        CodebookState(counter, torch.zeros(CB["reservoir_size"], 32), 0),
        make_adam(spec, model.named_parameters()), disc,
        make_adam(spec, disc.named_parameters()))
    return state


def _jax_step_setup(loss_cfg):
    jcfg = JVQModelConfig(**IMG_TINY, codebook=JCodebookConfig(**CB))
    jmodel, jd = JVQModel(jcfg), JDisc(base_filters=8)
    tx = jmake_adam(JOptimizerConfig(**OPT))
    st = jcreate_state(jmodel, jcfg, tx, jax.random.PRNGKey(0),
                       disc_model=jd, disc_tx=tx)
    emb = np.random.default_rng(0).standard_normal((16, 32)).astype(
        np.float32)
    params = {**st.params, "codebook_embedding": jnp.asarray(emb)}
    d_params = {"params": st.disc_params["params"],
                "batch_stats": jax.tree.map(
                    jnp.asarray, _stats(st.disc_params["batch_stats"], 6))}
    st = st.replace(params=params, opt_state=tx.init(params),
                    disc_params=d_params,
                    vq_state=st.vq_state.replace(
                        counter=jnp.int32(jcfg.codebook.q_re_end)))
    return jcfg, jmodel, jd, tx, st


def test_img_train_step_matches_jax():
    """One whole step in the quantized phase (counter past q_re_end, no
    k-means), disc_start 0, face loss on, accumulate_grad 1, from the same
    weights and batch: every metric rtol 1e-4; the VQ model's and the
    discriminator's parameters after their Adam update and both models'
    BN running statistics atol 1e-5; the codebook counter and the
    reservoir's fill.  The reservoir rows themselves are not compared:
    jax.random and torch draw different positions."""
    loss_cfg = dict(disc_start=0, face_loss=True)
    jcfg, jmodel, jd, tx, st = _jax_step_setup(loss_cfg)
    jlp, lp_vars, jfn, fn_vars, lp, fn = _jax_towers()
    variables = _np({"params": st.params, "batch_stats": st.batch_stats})
    state = _port_state(variables, _np(st.disc_params),
                        jcfg.codebook.q_re_end, lp, fn)
    before_g = {k: v.clone() for k, v in state.model.state_dict().items()}
    before_d = {k: v.clone() for k, v in state.disc.state_dict().items()}
    b = _batch(2)
    jstep = jmake_step(jmodel, jd, tx, tx, JVQGANLossConfig(**loss_cfg),
                       jlp, face_model=jfn, vq_impl="jnp", donate=False)
    st2, jm = jstep(st, {k: jnp.asarray(v) for k, v in b.items()},
                    {"lpips": lp_vars, "face": fn_vars},
                    jax.random.PRNGKey(1))
    step = make_img_train_step(state.model, state.disc, state.opt,
                               state.disc_opt, VQGANLossConfig(**loss_cfg),
                               lp, fn)
    m = step(state, *(torch.from_numpy(b[k]) for k in
                      ("image", "bbox_obj", "bbox_face")),
             torch.Generator().manual_seed(0))
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert float(m["d_loss"]) > 0 and float(m["face_loss"]) > 0
    assert state.step == 1 and state.vq_state.counter == \
        jcfg.codebook.q_re_end + 1 == int(st2.vq_state.counter)
    assert state.vq_state.filled == int(st2.vq_state.filled) == 2 * 4
    ref_g = vq_from_flax(_np({"params": st2.params,
                              "batch_stats": st2.batch_stats}),
                         state.model.cfg)
    ref_d = disc_from_flax(_np(st2.disc_params))
    for ref, mine, before in ((ref_g, state.model, before_g),
                              (ref_d, state.disc, before_d)):
        moved = 0
        for name, v in mine.state_dict().items():
            np.testing.assert_allclose(v.numpy(), ref[name].numpy(),
                                       atol=1e-5, err_msg=name)
            moved += not torch.equal(v, before[name])
        assert moved > len(ref) // 2


def _trained(tmp_path, steps=2):
    """A port state after ``steps`` micro-steps at accumulate_grad 3 (so
    the Adams stop half way through an accumulation)."""
    _, variables, _ = _vq_pair()
    jd = JDisc(base_filters=8)
    d_vars = _np(jd.init(jax.random.PRNGKey(4), jnp.zeros((1, 32, 32, 3))))
    *_, lp, fn = _jax_towers()
    state = _port_state(variables, d_vars, 5, lp, fn,
                        dict(OPT, accumulate_grad=3))
    step = make_img_train_step(state.model, state.disc, state.opt,
                               state.disc_opt,
                               VQGANLossConfig(disc_start=1), lp, fn)
    gen = torch.Generator().manual_seed(0)
    for i in range(steps):
        b = _batch(10 + i)
        step(state, *(torch.from_numpy(b[k]) for k in
                      ("image", "bbox_obj", "bbox_face")), gen)
    return state, variables, d_vars, lp, fn


def test_img_checkpoint_roundtrip_restores_both_towers(tmp_path):
    """Save after two micro-steps, restore into a fresh state: the VQ
    model, the discriminator with its BN statistics, the codebook state
    and both Adams (counters, moments, accumulators) bitwise."""
    state, variables, d_vars, lp, fn = _trained(tmp_path)
    checkpoint.save_checkpoint(str(tmp_path), state)
    fresh = _port_state(variables, d_vars, 0, lp, fn,
                        dict(OPT, accumulate_grad=3))
    checkpoint.restore_checkpoint(str(tmp_path), fresh)
    assert fresh.step == 2 and fresh.vq_state.counter == 7
    assert fresh.vq_state.filled == state.vq_state.filled
    assert torch.equal(fresh.vq_state.reservoir, state.vq_state.reservoir)
    for a, b in ((fresh.model, state.model), (fresh.disc, state.disc)):
        for k, v in b.state_dict().items():
            assert torch.equal(a.state_dict()[k], v), k
    for a, b in ((fresh.opt, state.opt), (fresh.disc_opt, state.disc_opt)):
        a, b = a.state_dict(), b.state_dict()
        assert (a["count"], a["mini_step"]) == (b["count"], b["mini_step"]) \
            == (0, 2)
        for part in ("mu", "nu", "acc"):
            for k, v in b[part].items():
                assert torch.equal(a[part][k], v), (part, k)


def test_frozen_towers_load_torch_checkpoints(tmp_path):
    """``frozen_towers`` reads a torchvision-layout LPIPS file (with the
    lin weights) and a VGGFace2 ResNet50 file into frozen towers in eval
    mode; without paths it builds the seeded random towers."""
    from mas_tpu_torch.losses import lpips as lpips_mod
    from mas_tpu_torch.train.loop import frozen_towers

    g = torch.Generator().manual_seed(0)
    lp_state, vgg = {}, LPIPS().vgg
    for name, idx in zip(lpips_mod._conv_names(), lpips_mod._TORCH_CONV_IDX):
        src = vgg.get_submodule(name)
        lp_state[f"features.{idx}.weight"] = torch.randn(
            src.weight.shape, generator=g)
        lp_state[f"features.{idx}.bias"] = torch.randn(src.bias.shape,
                                                       generator=g)
    for i, c in enumerate((64, 128, 256, 512, 512)):
        lp_state[f"lin{i}.model.1.weight"] = torch.rand(1, c, 1, 1,
                                                        generator=g)
    face_state = {k: (torch.randn(v.shape, generator=g)
                      if v.is_floating_point() else v)
                  for k, v in FaceNet().state_dict().items()}
    torch.save(lp_state, tmp_path / "lpips.pt")
    torch.save({"state_dict": face_state}, tmp_path / "face.pt")
    lp, fn = frozen_towers(VQGANLossConfig(), "cpu",
                           str(tmp_path / "lpips.pt"),
                           str(tmp_path / "face.pt"))
    assert torch.equal(lp.vgg.conv4_1.weight, lp_state["features.26.weight"])
    assert torch.equal(lp.lin3, lp_state["lin3.model.1.weight"].reshape(
        1, -1).T)
    assert torch.equal(fn.layer3[5].bn2.running_var,
                       face_state["layer3.5.bn2.running_var"])
    assert not lp.training and not fn.training
    assert not any(p.requires_grad for p in
                   list(lp.parameters()) + list(fn.parameters()))
    rand_lp, none = frozen_towers(VQGANLossConfig(face_loss=False), "cpu")
    assert none is None and not torch.equal(rand_lp.vgg.conv0_0.weight,
                                            lp.vgg.conv0_0.weight)


def _cli_config(tmp_path, total_steps, resume):
    cfg = {"train": {"mode": "pretrain_image", "total_steps": total_steps,
                     "batch_size": 2, "log_period": 1,
                     "checkpoint_dir": str(tmp_path / "ck"),
                     "resume": resume,
                     "optimizer": {"lr": 1e-3, "accumulate_grad": 2},
                     "disc_optimizer": {"lr": 2e-3, "accumulate_grad": 2}},
           "model": dict(IMG_TINY, codebook=dict(CB, init_steps=1)),
           # the face term is held to JAX above; a ResNet50 over 24 faces
           # of 254^2 a step would take this CPU test tens of seconds
           "loss": {"disc_start": 1, "face_loss": False},
           "lpips_weights": None, "face_weights": None,
           "data": {"kind": "synthetic", "resolution": 32}}
    path = tmp_path / f"img_{total_steps}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_cli_pretrain_image_runs_and_resumes_bitwise(tmp_path, monkeypatch,
                                                     capsys):
    """``--mode pretrain_image --device cpu`` on a tiny config for 2 steps
    (the discriminator gated at step 0, active at step 1), the state
    rebuilt from its checkpoint equal bitwise to the one trained, then a
    resumed CLI run to step 3."""
    from mas_tpu_torch.cli import main
    from mas_tpu_torch.train.loop import build_img_state, run_pretrain_image
    from mas_tpu_torch.utils.logging import Logger

    monkeypatch.chdir(tmp_path)
    assert main(["--config", _cli_config(tmp_path, 2, False), "--mode",
                 "pretrain_image", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    logged = [json.loads(line) for line in out.splitlines()
              if line.startswith("{")]
    assert [e["step"] for e in logged] == [1, 2]
    assert [e["disc_factor"] for e in logged] == [0.0, 1.0]
    assert logged[0]["d_loss"] == 0.0 and logged[1]["d_loss"] > 0
    for e in logged:
        assert all(np.isfinite(v) for v in e.values())
    ck = str(tmp_path / "ck")
    assert checkpoint.latest_step(ck) == 2
    payload = torch.load(checkpoint.checkpoint_path(ck, 2), weights_only=True)
    assert payload["optimizer"]["count"] == 1
    assert payload["disc_optimizer"]["count"] == 1

    raw = json.loads(open(_cli_config(tmp_path, 2, False)).read())
    train_cfg = TrainConfig.from_dict(dict(raw["train"], checkpoint_dir=str(
        tmp_path / "ck2")))
    model_cfg = VQModelConfig.from_dict(raw["model"])
    from mas_tpu_torch.cli import data_iter
    state = run_pretrain_image(
        train_cfg, model_cfg, data_iter(raw["data"], 2, model_cfg),
        VQGANLossConfig.from_dict(raw["loss"]), device="cpu",
        logger=Logger(str(tmp_path / "logs2"), image_period=2,
                      use_tensorboard=False))
    assert os.path.isfile(tmp_path / "logs2" / "samples_2.jpg")
    resumed = build_img_state(dataclasses.replace(train_cfg, resume=True),
                              model_cfg, "cpu")
    assert resumed.step == state.step == 2
    assert resumed.vq_state.counter == state.vq_state.counter
    assert torch.equal(resumed.vq_state.reservoir, state.vq_state.reservoir)
    for a, b in ((resumed.model, state.model), (resumed.disc, state.disc)):
        for k, v in b.state_dict().items():
            assert torch.equal(a.state_dict()[k], v), k
    for a, b in ((resumed.opt, state.opt), (resumed.disc_opt,
                                             state.disc_opt)):
        assert a.count == b.count and a.mini_step == b.mini_step
        for part in ("mu", "nu"):
            for k, v in getattr(b, part).items():
                assert torch.equal(getattr(a, part)[k], v), (part, k)

    assert main(["--config", _cli_config(tmp_path, 3, True), "--device",
                 "cpu"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "trained to step 3" in out


def test_img_512_config_validates():
    """configs/img_512.json builds the port's configs unchanged: 512^2,
    the default channels, K 8192, bf16, both Adams at accumulation 8."""
    from mas_tpu_torch.cli import data_iter

    with open(os.path.join(REPO, "configs", "img_512.json")) as f:
        raw = json.load(f)
    train = TrainConfig.from_dict(raw["train"])
    model = VQModelConfig.from_dict(raw["model"])
    loss = VQGANLossConfig.from_dict(raw["loss"])
    assert train.mode == "pretrain_image"
    assert train.optimizer.accumulate_grad == \
        train.disc_optimizer.accumulate_grad == 8
    assert (train.optimizer.lr, train.disc_optimizer.lr) == (5e-6, 4.5e-6)
    assert model.channels == (128, 128, 128, 256, 512, 512)
    assert model.compute_dtype == "bfloat16"
    assert (model.latent_resolution, model.codebook.codebook_size) == \
        (32, 8192)
    assert loss.disc_start == 250_001 and loss.face_loss
    assert raw["lpips_weights"] is None and raw["face_weights"] is None
    batch = next(data_iter({"kind": "synthetic", "resolution": 16}, 2,
                           model))
    assert batch["image"].shape == (2, 16, 16, 3)


def test_img_stage_divides_both_learning_rates():
    """The image stage's state: both Adams at lr / accumulate_grad, as
    ``mas_tpu/train/loop.py::run_pretrain_image``; the discriminator over
    the model's output channels with 64 base filters."""
    from mas_tpu_torch.train.state import create_vq_train_state

    st = create_vq_train_state(
        VQModelConfig(**IMG_TINY, codebook=CB), OptimizerConfig(
            lr=8e-3, accumulate_grad=4), torch.Generator().manual_seed(0),
        "cpu", disc_opt_cfg=OptimizerConfig(lr=4e-3, accumulate_grad=2))
    assert st.opt.lr == 2e-3 and st.disc_opt.lr == 2e-3
    assert st.disc.conv_0.weight.shape == (64, 3, 4, 4)
    assert st.model.last_layer.dtype == torch.float32
