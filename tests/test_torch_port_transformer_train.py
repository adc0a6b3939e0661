"""The port's transformer training vs the JAX package, on CPU: loss and
gradients of ``MakeAScene``, the whole train step with CFG dropout and
Adam, the synthetic token data, checkpoints, ``--mode train_transformer``,
and the three repairs of this path (the attention gradient through
``FlashAttentionFunction`` is tested in ``test_torch_port_ops.py``): fp32
master parameters of a bf16 model, and remat.

Sizes are ``T_TINY`` (2 layers, hidden 128, 2 heads of 64, T = 8 + 16 +
16 = 40); fp32; weights cross with ``transformer_from_flax``; tokens come
from numpy draws.  Tolerances: fp32 atol 1e-5 for the loss and every
gradient (the two packages sum the same products in other orders).
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mas_tpu.data.dataset import SyntheticTokenBatches as JSyntheticTokens
from mas_tpu.models.transformer import MakeAScene as JMakeAScene
from mas_tpu.train.state import TransformerTrainState as JTrainState
from mas_tpu.train.state import make_adam as jmake_adam
from mas_tpu.train.steps import make_transformer_train_step as jmake_step
from mas_tpu.utils.config import OptimizerConfig as JOptimizerConfig
from mas_tpu.utils.config import TransformerConfig as JTransformerConfig

from mas_tpu_torch.data.dataset import SyntheticTokenBatches
from mas_tpu_torch.models.transformer import MakeAScene
from mas_tpu_torch.train.state import (TransformerTrainState,
                                       create_transformer_train_state,
                                       make_adam)
from mas_tpu_torch.train.steps import (make_transformer_train_step,
                                       transformer_loss_and_grads)
from mas_tpu_torch.utils import checkpoint
from mas_tpu_torch.utils.config import (ConfigError, OptimizerConfig,
                                        TrainConfig, TransformerConfig)
from mas_tpu_torch.utils.weights import transformer_from_flax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_models import T_TINY, _np_tree, _tokens  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Adam divides by sqrt(v) + eps; a gradient that is zero up to rounding
# would get an update of +-lr of either sign at eps = 1e-8 in either
# package, so the comparisons use a large eps (see the VQ-SEG step test)
OPT = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-3)


def _pair(seed=0, **kw):
    """JAX MakeAScene + its params, and the port's training model (fp32
    parameters) with the same weights."""
    cfg = dict(T_TINY, **kw)
    jmodel = JMakeAScene(JTransformerConfig(**cfg))
    variables = jmodel.init(
        jax.random.PRNGKey(seed),
        jnp.zeros((1, T_TINY["text_length"]), jnp.int32),
        jnp.zeros((1, T_TINY["seg_tokens_per_dim"] ** 2), jnp.int32),
        jnp.zeros((1, T_TINY["image_tokens_per_dim"] ** 2), jnp.int32))
    model = MakeAScene(TransformerConfig(**cfg), fp32_params=True)
    model.load_state_dict(transformer_from_flax(_np_tree(variables),
                                                model.cfg), strict=True)
    return jmodel, variables["params"], model


def _jax_loss(jmodel, params, text, seg, img):
    logits = jmodel.apply({"params": params}, text, seg, img)
    return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
        logits.astype(jnp.float32), img))


@pytest.mark.parametrize("flags", [
    dict(attention_impl="pallas_interpret"), dict(attention_impl="jnp"),
    dict(cogview_sandwich_layernorm=False, attention_impl="pallas_interpret"),
    dict(prefix_bidirectional=False, attention_impl="jnp")])
def test_loss_and_gradients_match_jax(flags):
    """Loss and every parameter gradient against jax.value_and_grad of the
    JAX loss, the gradient tree mapped through transformer_from_flax."""
    jmodel, params, model = _pair(seed=1, **flags)
    text, seg, img = _tokens(model.cfg, seed=2)
    j = lambda a: jnp.asarray(a, jnp.int32)
    jloss, jgrads = jax.value_and_grad(_jax_loss, argnums=1)(
        jmodel, params, j(text), j(seg), j(img))
    want = transformer_from_flax(_np_tree({"params": jgrads}), model.cfg)
    t = torch.from_numpy
    loss, grads = transformer_loss_and_grads(model, t(text), t(seg), t(img))
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("uncond_p", [0.0, 1.0])
def test_train_step_matches_jax(uncond_p):
    """One whole step against make_transformer_train_step: uncond_p 0 and
    1 leave the draw no say, so the packages cannot disagree on it.  Loss
    atol 1e-5; parameters after the Adam update atol 1e-6 (one update moves
    a parameter by <= lr)."""
    jmodel, params, model = _pair(seed=3)
    tx = jmake_adam(JOptimizerConfig(**OPT), rescale_lr=False)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         opt_state=tx.init(params))
    jstep = jmake_step(jmodel, tx, uncond_p=uncond_p, donate=False)
    text, seg, img = _tokens(model.cfg, seed=4)
    j = lambda a: jnp.asarray(a, jnp.int32)
    jstate, jm = jstep(jstate, j(text), j(seg), j(img),
                       jax.random.PRNGKey(5))
    opt = make_adam(OptimizerConfig(**OPT), model.named_parameters(),
                    rescale_lr=False)
    state = TransformerTrainState(0, model, opt)
    step = make_transformer_train_step(model, opt, uncond_p=uncond_p)
    t = torch.from_numpy
    m = step(state, t(text), t(seg), t(img), torch.Generator().manual_seed(5))
    assert state.step == 1 and bool(m["uncond"]) == bool(jm["uncond"]) \
        == (uncond_p == 1.0)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               atol=1e-5)
    ref = transformer_from_flax(_np_tree({"params": jstate.params}),
                                model.cfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   atol=1e-6, err_msg=name)


def test_uncond_waits_for_start_uncond():
    """Before start_uncond the text stays, from it on uncond_p 1.0 drops it
    for the whole batch (the pad remap then feeds the model)."""
    state = create_transformer_train_state(
        TransformerConfig(**T_TINY), OptimizerConfig(**OPT),
        torch.Generator().manual_seed(0), "cpu")
    step = make_transformer_train_step(state.model, state.opt, uncond_p=1.0,
                                       start_uncond=1)
    text, seg, img = (torch.from_numpy(a) for a in _tokens(state.model.cfg))
    gen = torch.Generator().manual_seed(0)
    flags = [bool(step(state, text, seg, img, gen)["uncond"])
             for _ in range(3)]
    assert flags == [False, True, True]


def test_synthetic_token_batches_match_jax():
    cfg = TransformerConfig(**T_TINY)
    got, want = (iter(cls(3, cfg, seed=7)) for cls in
                 (SyntheticTokenBatches, JSyntheticTokens))
    for _ in range(2):
        a, b = next(got), next(want)
        assert set(a) == set(b) == {"text", "seg", "image"}
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# --- repairs ---------------------------------------------------------------

def test_bf16_training_model_holds_fp32_and_every_weight_moves():
    """A bf16 model built for training holds only fp32 parameters, casts
    them to bf16 at use (bf16 logits before the fp32 cast), and one Adam
    step at lr 4.5e-6 changes every weight tensor: on a bf16 weight of
    magnitude 0.02 the update would be under half an ulp and round away."""
    cfg = TransformerConfig(**T_TINY, compute_dtype="bfloat16")
    state = create_transformer_train_state(
        cfg, OptimizerConfig(lr=4.5e-6, beta1=0.9, beta2=0.95),
        torch.Generator().manual_seed(0), "cpu")
    model = state.model
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    text, seg, img = (torch.from_numpy(a) for a in _tokens(cfg))
    assert model.embed_text(text).dtype == torch.bfloat16
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_transformer_train_step(model, state.opt, uncond_p=0.0)
    m = step(state, text, seg, img, torch.Generator().manual_seed(0))
    assert np.isfinite(float(m["loss"]))
    for name, p in model.named_parameters():
        assert not torch.equal(p, before[name]), name
    # the serving model keeps its one-time cast
    serving = MakeAScene(cfg)
    assert serving.transformer.layers[0].attn.qkv.weight.dtype == \
        torch.bfloat16


@pytest.mark.parametrize("policy", ["mlp", "nothing", "dots"])
def test_remat_policies_leave_loss_and_gradients_unchanged(policy):
    """remat recomputes in the backward pass; loss and every gradient
    equal the run without it (fp32 atol 1e-6)."""
    base = MakeAScene(TransformerConfig(**T_TINY), fp32_params=True)
    remat = MakeAScene(TransformerConfig(**T_TINY, remat=True,
                                         remat_policy=policy),
                       fp32_params=True)
    remat.load_state_dict(base.state_dict(), strict=True)
    text, seg, img = (torch.from_numpy(a) for a in _tokens(base.cfg))
    loss, grads = transformer_loss_and_grads(base, text, seg, img)
    rloss, rgrads = transformer_loss_and_grads(remat, text, seg, img)
    np.testing.assert_allclose(float(rloss), float(loss), atol=1e-6)
    for (name, _), g, rg in zip(base.named_parameters(), grads, rgrads):
        np.testing.assert_allclose(rg.numpy(), g.numpy(), atol=1e-6,
                                   err_msg=name)


def test_remat_policy_is_validated():
    with pytest.raises(ConfigError, match="remat_policy"):
        TransformerConfig(**T_TINY, remat=True, remat_policy="everything")


def test_transformer_config_loads_unchanged():
    with open(os.path.join(REPO, "configs", "transformer_512.json")) as f:
        raw = json.load(f)
    train = TrainConfig.from_dict(raw["train"])
    cfg = TransformerConfig.from_dict(raw["transformer"])
    assert train.mode == "train_transformer" and train.uncond_p == 0.1
    assert (train.optimizer.beta1, train.optimizer.beta2) == (0.9, 0.95)
    assert (cfg.num_layers, cfg.hidden_dim, cfg.total_length,
            cfg.prefix_length) == (24, 1024, 1408, 384)
    assert cfg.remat and cfg.remat_policy == "mlp"
    TransformerConfig.from_dict(dict(raw["transformer"],
                                     layernorm_impl="pallas"))


# --- checkpoints and the CLI ------------------------------------------------

def _trained_state(steps=2):
    state = create_transformer_train_state(
        TransformerConfig(**T_TINY), OptimizerConfig(**OPT),
        torch.Generator().manual_seed(0), "cpu")
    step = make_transformer_train_step(state.model, state.opt)
    gen = torch.Generator().manual_seed(1)
    for i in range(steps):
        text, seg, img = (torch.from_numpy(a)
                          for a in _tokens(state.model.cfg, seed=10 + i))
        step(state, text, seg, img, gen)
    return state


def test_checkpoint_roundtrip_is_bitwise_and_serves(tmp_path):
    """Save after two steps, restore into a fresh state: step, model and
    Adam state bitwise; the file has no codebook part and loads into the
    sampler's model through cli.load_transformer (strict)."""
    from mas_tpu_torch.cli import load_transformer

    state = _trained_state()
    path = checkpoint.save_checkpoint(str(tmp_path), state)
    assert "codebook" not in torch.load(path, weights_only=True)
    fresh = _trained_state(steps=0)
    checkpoint.restore_checkpoint(str(tmp_path), fresh)
    assert fresh.step == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    a, b = fresh.opt.state_dict(), state.opt.state_dict()
    assert (a["count"], a["mini_step"]) == (b["count"], b["mini_step"])
    for part in ("mu", "nu"):
        for k, v in b[part].items():
            assert torch.equal(a[part][k], v), (part, k)
    served = load_transformer(dataclasses.replace(state.model.cfg,
                                                  compute_dtype="bfloat16"),
                              path, "cpu", torch.Generator())
    w = "transformer.layers.0.attn.qkv.weight"
    assert torch.equal(served.state_dict()[w],
                       state.model.state_dict()[w].bfloat16())


def _cli_config(tmp_path, total_steps, resume):
    cfg = {"train": {"mode": "train_transformer",
                     "total_steps": total_steps, "batch_size": 2,
                     "log_period": 1, "checkpoint_dir": str(tmp_path / "ck"),
                     "resume": resume, "uncond_p": 0.5,
                     "optimizer": {"lr": 1e-3, "beta1": 0.9, "beta2": 0.95}},
           "transformer": dict(T_TINY, remat=True, remat_policy="mlp"),
           "data": {"kind": "synthetic"}}
    path = tmp_path / f"t_{total_steps}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_cli_train_transformer_resumes(tmp_path, monkeypatch, capsys):
    """CPU run of --mode train_transformer for 2 steps, then a resumed run
    to step 3 that continues from the checkpoint."""
    from mas_tpu_torch.cli import main

    monkeypatch.chdir(tmp_path)
    assert main(["--config", _cli_config(tmp_path, 2, False),
                 "--device", "cpu"]) == 0
    ck = str(tmp_path / "ck")
    assert checkpoint.latest_step(ck) == 2
    assert main(["--config", _cli_config(tmp_path, 3, True), "--mode",
                 "train_transformer", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "trained to step 3" in out
    logged = [json.loads(line) for line in out.splitlines()
              if line.startswith("{")]
    assert [e["step"] for e in logged] == [1, 2, 3]
    assert all(np.isfinite(e["loss"]) and e["uncond"] in (0, 1)
               for e in logged)
    payload = torch.load(checkpoint.checkpoint_path(ck, 3), weights_only=True)
    assert payload["optimizer"]["count"] == 3 and payload["step"] == 3
