"""The port's VQ-SEG training vs the JAX package, on CPU: the whole train
step, Adam with accumulation, the k-means micro-step, checkpoints and the
``--mode pretrain_segmentation`` CLI.

Sizes are tiny (channels (32, 32, 64), 32^2, 159 channels, K = 64, D = 32,
reservoir 512); fp32; weights cross with ``vq_from_flax``; batches come
from the JAX package's ``SyntheticSegBatches``.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mas_tpu.models.vqvae import VQModel as JVQModel
from mas_tpu.train.state import create_vq_train_state as jcreate_state
from mas_tpu.train.state import make_adam as jmake_adam
from mas_tpu.train.steps import make_seg_train_step as jmake_step
from mas_tpu.utils.config import CodebookConfig as JCodebookConfig
from mas_tpu.utils.config import OptimizerConfig as JOptimizerConfig
from mas_tpu.utils.config import VQModelConfig as JVQModelConfig

from mas_tpu_torch.models.codebook import CodebookState
from mas_tpu_torch.models.vqvae import VQModel
from mas_tpu_torch.train.state import VQTrainState, make_adam
from mas_tpu_torch.train.steps import make_seg_train_step
from mas_tpu_torch.utils import checkpoint
from mas_tpu_torch.utils.config import OptimizerConfig, VQModelConfig
from mas_tpu_torch.utils.weights import load_reference_pt, vq_from_flax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_vq import CB_TINY, SEG_TINY, _seg_batch  # noqa: E402

# Adam divides by sqrt(v) + eps.  Conv biases ahead of a normalization have
# a gradient that is zero up to rounding, and at eps = 1e-8 that noise gets
# an update of +-lr of either sign in either package; eps = 1e-3 keeps the
# comparison about the algorithm.
OPT = dict(lr=1e-3, eps=1e-3, accumulate_grad=3)


def _port_state(variables, counter, opt_spec=OPT):
    model = VQModel(VQModelConfig(**SEG_TINY, codebook=CB_TINY))
    model.load_state_dict(vq_from_flax(variables, model.cfg), strict=True)
    opt = make_adam(OptimizerConfig(**opt_spec), model.named_parameters(),
                    rescale_lr=False)
    vq_state = CodebookState(counter, torch.zeros(CB_TINY["reservoir_size"],
                                                  CB_TINY["codebook_dim"]), 0)
    return VQTrainState(0, model, vq_state, opt)


def test_seg_train_step_matches_jax():
    """Three micro-steps with accumulate_grad 3 from a state whose counter
    is past q_re_end (quantize phase, no k-means): per-step loss and q_loss
    rtol 1e-5; parameters unchanged until the third micro-step, then
    parameters and BN running stats atol 1e-6 (fp32; the losses agree to
    ~1e-6 relative, and one Adam update moves a parameter by <= lr)."""
    jcfg = JVQModelConfig(**SEG_TINY, codebook=JCodebookConfig(**CB_TINY))
    jmodel = JVQModel(jcfg)
    tx = jmake_adam(JOptimizerConfig(**OPT), rescale_lr=False)
    st = jcreate_state(jmodel, jcfg, tx, jax.random.PRNGKey(0))
    emb = np.random.default_rng(0).standard_normal((64, 32)).astype(
        np.float32)
    params = {**st.params, "codebook_embedding": jnp.asarray(emb)}
    st = st.replace(params=params, opt_state=tx.init(params),
                    vq_state=st.vq_state.replace(
                        counter=jnp.int32(jcfg.codebook.q_re_end)))
    variables = jax.tree.map(np.asarray, {"params": st.params,
                                          "batch_stats": st.batch_stats})
    state = _port_state(variables, jcfg.codebook.q_re_end)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    step = make_seg_train_step(state.model, state.opt)
    jstep = jmake_step(jmodel, tx, donate=False)
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(1)
    for i in range(3):
        seg = _seg_batch(20 + i)
        key, k = jax.random.split(key)
        st, jm = jstep(st, jnp.asarray(seg), k)
        m = step(state, torch.from_numpy(seg), gen)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["q_loss"]), float(jm["q_loss"]),
                                   rtol=1e-5)
        assert not m["kmeans_triggered"] and state.step == i + 1
        if i < 2:
            for name, p in state.model.named_parameters():
                assert torch.equal(p, before[name]), name
    assert state.vq_state.counter == jcfg.codebook.q_re_end + 3
    assert state.vq_state.filled == 3 * 2 * CB_TINY["samples_per_image"]
    ref = vq_from_flax(jax.tree.map(np.asarray, {
        "params": st.params, "batch_stats": st.batch_stats}),
        state.model.cfg)
    moved = 0
    for name, v in state.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[name].numpy(), atol=1e-6,
                                   err_msg=name)
        moved += not torch.equal(v, before[name])
    assert moved > len(ref) // 2


@pytest.mark.parametrize("rescale", [False, True])
def test_adam_with_accumulation_matches_make_adam(rescale):
    """Six micro-steps with accumulate_grad 3 (two updates), against
    optax's adam behind MultiSteps: parameters after every micro-step,
    fp32 atol 1e-7 (one rounding of the update)."""
    r = np.random.default_rng(int(rescale))
    p0 = {"a": r.standard_normal((4, 3)).astype(np.float32),
          "b": r.standard_normal(5).astype(np.float32)}
    grads = [{k: r.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(6)]
    spec = dict(lr=0.01, beta1=0.5, beta2=0.9, accumulate_grad=3)
    tx = jmake_adam(JOptimizerConfig(**spec), rescale_lr=rescale)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    opt = make_adam(OptimizerConfig(**spec), tp.items(), rescale_lr=rescale)
    for i, g in enumerate(grads):
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                            jp)
        jp = {k: jp[k] + upd[k] for k in jp}
        applied = opt.step([torch.from_numpy(g[k]) for k in tp])
        assert applied == (i % 3 == 2) and opt.count == (i + 1) // 3
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-7, err_msg=f"{k} step {i}")


def _trained_state(tmp_path, steps=2, counter=None, accumulate=1):
    from test_torch_port_vq import seg_pair

    _, variables, _ = seg_pair(seed=3)
    cb = CB_TINY
    state = _port_state(variables, cb["init_steps"] * 3 - 1 if counter is None
                        else counter, dict(OPT, accumulate_grad=accumulate))
    r = np.random.default_rng(4)
    state.vq_state.reservoir[:200] = torch.from_numpy(
        r.standard_normal((200, 32)).astype(np.float32))
    state.vq_state.filled = 200
    step = make_seg_train_step(state.model, state.opt)
    gen = torch.Generator().manual_seed(5)
    metrics = [step(state, torch.from_numpy(_seg_batch(30 + i)), gen)
               for i in range(steps)]
    return state, metrics


def test_kmeans_micro_step_writes_back_after_the_update(tmp_path):
    """The micro-step at counter q_init runs k-means, quantizes with the
    centroids and stores them in the codebook after the optimizer update;
    the codebook's gradient on that micro-step is zero, so Adam's first
    moment of it stays 0 while the other parameters move."""
    state, (m,) = _trained_state(tmp_path, steps=1)
    assert m["kmeans_triggered"] and state.vq_state.counter == 6
    emb = state.model.quantize.embedding.weight
    assert torch.equal(emb, m["centroids"])
    name = "quantize.embedding.weight"
    assert float(state.opt.mu[name].abs().max()) == 0.0
    assert float(state.opt.mu["quant_conv.0.weight"].abs().max()) > 0.0
    assert np.isfinite(float(m["loss"])) and float(m["q_loss"]) > 0


def test_packed_labels_step_equals_dense_step(tmp_path):
    """``from_packed_labels`` expands int16 label maps on the device; the
    step then sees the same one-hot as a dense batch (same loss, fp32
    bitwise)."""
    from mas_tpu.data.segmap import assemble_seg_map, pack_seg_labels

    r = np.random.default_rng(6)
    pan, hum = r.integers(-1, 133, (2, 32, 32)), r.integers(-1, 20, (2, 32, 32))
    face, edge = r.integers(0, 6, (2, 32, 32)), r.integers(0, 3, (2, 32, 32))
    packed = np.stack([pack_seg_labels(pan[i], edge[i], hum[i], face[i])
                       for i in range(2)])
    dense = np.stack([assemble_seg_map(pan[i], edge[i], hum[i],
                                       np.zeros((32, 32)), face[i])
                      for i in range(2)])
    losses = []
    for packed_labels, batch in ((True, packed), (False, dense)):
        state, _ = _trained_state(tmp_path, steps=0, counter=100)
        step = make_seg_train_step(state.model, state.opt,
                                   from_packed_labels=packed_labels)
        losses.append(float(step(state, torch.from_numpy(batch),
                                 torch.Generator().manual_seed(0))["loss"]))
    assert losses[0] == losses[1]


def test_checkpoint_roundtrip_restores_everything(tmp_path):
    """Save after two micro-steps (accumulation half way), restore into a
    fresh state: model, counter, filled, reservoir and optimizer state
    bitwise; the model part reads back through load_reference_pt."""
    state, _ = _trained_state(tmp_path, steps=2, counter=10, accumulate=3)
    path = checkpoint.save_checkpoint(str(tmp_path), state)
    assert checkpoint.latest_step(str(tmp_path)) == 2
    fresh, _ = _trained_state(tmp_path, steps=0, counter=0, accumulate=3)
    checkpoint.restore_checkpoint(str(tmp_path), fresh)
    assert fresh.step == 2 and fresh.vq_state.counter == 12
    assert fresh.vq_state.filled == state.vq_state.filled
    assert torch.equal(fresh.vq_state.reservoir, state.vq_state.reservoir)
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    a, b = fresh.opt.state_dict(), state.opt.state_dict()
    assert (a["count"], a["mini_step"]) == (b["count"], b["mini_step"]) \
        == (0, 2)
    for part in ("mu", "nu", "acc"):
        for k, v in b[part].items():
            assert torch.equal(a[part][k], v), (part, k)
    model = VQModel(state.model.cfg)
    model.load_state_dict(load_reference_pt(path), strict=True)


def _cli_config(tmp_path, total_steps, resume):
    cfg = {"train": {"mode": "pretrain_segmentation",
                     "total_steps": total_steps, "batch_size": 2,
                     "log_period": 1, "checkpoint_dir": str(tmp_path / "ck"),
                     "resume": resume,
                     "optimizer": {"lr": 1e-3, "accumulate_grad": 2}},
           "model": dict(SEG_TINY, codebook=dict(CB_TINY, init_steps=1)),
           "loss": {"image_channels": 159},
           "data": {"kind": "synthetic", "resolution": 32}}
    path = tmp_path / f"seg_{total_steps}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_cli_pretrain_segmentation_resumes(tmp_path, monkeypatch, capsys):
    """CPU run of --mode pretrain_segmentation on a tiny config, then a
    resumed run that continues the phase counter and the checkpoints."""
    from mas_tpu_torch.cli import main

    monkeypatch.chdir(tmp_path)
    assert main(["--config", _cli_config(tmp_path, 3, False),
                 "--device", "cpu"]) == 0
    ck = str(tmp_path / "ck")
    assert checkpoint.latest_step(ck) == 3
    assert main(["--config", _cli_config(tmp_path, 5, True), "--mode",
                 "pretrain_segmentation", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "trained to step 5" in out
    logged = [json.loads(line) for line in out.splitlines()
              if line.startswith("{")]
    assert [e["step"] for e in logged] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(e["loss"]) for e in logged)
    # init_steps 1: k-means at counters 3, 4 and 5 (q_init 3, every step)
    assert [e["kmeans_triggered"] for e in logged] == [0, 0, 1, 1, 1]
    payload = torch.load(checkpoint.checkpoint_path(ck, 5),
                         weights_only=True)
    assert payload["codebook"]["counter"] == 5
    assert payload["optimizer"]["count"] == 2
    assert os.path.isfile(tmp_path / "logs" / "metrics.jsonl")


def test_cli_refuses_unported_data_and_train_fields(tmp_path):
    """Every data kind of the JAX package is ported: an unknown kind is a
    ConfigError and a missing shard fails the run, as in ``mas_tpu``; the
    distribution fields still raise, naming A12."""
    from mas_tpu_torch.cli import main
    from mas_tpu_torch.utils.config import ConfigError, TrainConfig

    raw = json.loads(open(_cli_config(tmp_path, 1, False)).read())
    for data, error in (({"kind": "webdataset", "shards": "x"},
                         FileNotFoundError),
                        ({"kind": "tfrecord"}, ConfigError)):
        raw["data"] = data
        path = tmp_path / "web.json"
        path.write_text(json.dumps(raw))
        with pytest.raises(error):
            main(["--config", str(path), "--device", "cpu"])
    for field, item in ((dict(mesh={"data": 2}), "A12"),
                        (dict(allow_replicated_batch=True), "A12")):
        with pytest.raises(NotImplementedError, match=item):
            TrainConfig(**field)


def test_seg_config_loads_unchanged():
    from mas_tpu_torch.utils.config import (SegLossConfig, TrainConfig,
                                            VQModelConfig)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "configs", "seg_256.json")) as f:
        raw = json.load(f)
    train = TrainConfig.from_dict(raw["train"])
    model = VQModelConfig.from_dict(raw["model"])
    loss = SegLossConfig.from_dict(raw["loss"])
    assert train.optimizer.accumulate_grad == 3 and train.batch_size == 2
    assert (model.in_channels, model.latent_resolution) == (159, 16)
    cb = model.codebook
    assert (cb.q_start_collect, cb.q_init, cb.q_re_end, cb.q_re_step) == \
        (2000, 6000, 60000, 1000)
    assert loss.face_weight == 20.0
