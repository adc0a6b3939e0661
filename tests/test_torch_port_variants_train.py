"""The transformer's variants in training and through the CLI, on CPU,
against the JAX package: loss and every parameter gradient of
grouped-query attention and of rudalle_relax with the LayerNorm prescale
(against ``jax.value_and_grad``), ``--mode sample`` of each variant,
``--mode export`` of a grouped-query model, and a grouped-query training
checkpoint dir served by ``--mode sample``.  Tolerances as in
``test_torch_port_variants.py``: gradients atol 1e-5 for grouped-query
attention (fp32 products summed in other orders), atol 1e-4 + rtol 1e-3
for rudalle_relax (the fused form against JAX's unfused CPU path).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mas_tpu_torch.train.steps import transformer_loss_and_grads
from mas_tpu_torch.utils.weights import transformer_from_flax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_models import _np_tree  # noqa: E402
from test_torch_port_variants import (RUDALLE, V_TINY, _j, _pair,  # noqa: E402
                                      _tokens)


def _jax_loss(jmodel, params, text, seg, img):
    import optax

    logits = jmodel.apply({"params": params}, text, seg, img)
    return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
        logits.astype(jnp.float32), img))


def _grads_match(flags, atol, rtol=0.0, seed=5):
    """Loss and every parameter gradient of the port's training model
    against jax.value_and_grad, the gradient tree mapped through
    ``transformer_from_flax``."""
    jmodel, variables, model = _pair(seed=seed, fp32_params=True, **flags)
    text, seg, img = _tokens(model.cfg, seed=seed + 1)
    jloss, jgrads = jax.value_and_grad(_jax_loss, argnums=1)(
        jmodel, variables["params"], _j(text), _j(seg), _j(img))
    want = transformer_from_flax(_np_tree({"params": jgrads}), model.cfg)
    t = torch.from_numpy
    loss, grads = transformer_loss_and_grads(model.train(), t(text), t(seg),
                                             t(img))
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=atol,
                                   rtol=rtol, err_msg=name)


@pytest.mark.parametrize("kv_heads", [2, 1])
def test_gqa_loss_and_gradients_match_jax(kv_heads):
    """k and v expanded to the query heads by ``repeat_interleave``: each kv
    head's gradient is the sum over its group, as JAX's ``jnp.repeat``."""
    _grads_match(dict(num_kv_heads=kv_heads), atol=1e-5)


@pytest.mark.parametrize("bidir", [True, False])
def test_rudalle_loss_and_gradients_match_jax(bidir):
    """Gradients through sigma (kept, as the reference backprops through
    it) and the detached maxima, against the unfused JAX path."""
    _grads_match(dict(prefix_bidirectional=bidir, **RUDALLE), atol=1e-4,
                 rtol=1e-3)


# --- the CLI --------------------------------------------------------------------------

def _cli_config(tmp_path, name, **transformer):
    from test_torch_port_pipeline import VQ_SLICE

    raw = {"transformer": dict(V_TINY, image_tokens_per_dim=2,
                               **transformer),
           "model": dict(VQ_SLICE, resolution=4),
           "captions": ["a red car", "two dogs"], "top_k": 4,
           "output": str(tmp_path / f"{name}.jpg"),
           "train": {"seed": 0, "batch_size": 2}}
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(raw))
    return str(path)


@pytest.mark.parametrize("name,flags", [
    ("gqa", dict(num_kv_heads=2, kv_cache_dtype="int4",
                 kv_scale_dtype="bfloat16")),
    ("rudalle", dict(RUDALLE, ln_matmul_fold=True))])
def test_cli_samples_each_variant(tmp_path, capsys, name, flags):
    from mas_tpu_torch.cli import main

    assert main(["--config", _cli_config(tmp_path, name, **flags),
                 "--mode", "sample", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert out.endswith(f"{name}.jpg") and os.path.getsize(out) > 0


def test_cli_export_refuses_gqa_as_jax_does(tmp_path):
    from mas_tpu.utils.torch_export import export_transformer_state

    from mas_tpu_torch.cli import main

    jmodel, variables, _ = _pair(seed=10, num_kv_heads=2)
    with pytest.raises(ValueError) as want:
        export_transformer_state(_np_tree(variables), jmodel.cfg)
    raw = {"transformer": dict(V_TINY, num_kv_heads=2),
           "output": str(tmp_path / "t.pt"), "train": {"seed": 0}}
    path = tmp_path / "export.json"
    path.write_text(json.dumps(raw))
    with pytest.raises(ValueError) as got:
        main(["--config", str(path), "--mode", "export", "--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert not (tmp_path / "t.pt").exists()


def test_gqa_training_dir_serves_in_sample(tmp_path, monkeypatch, capsys):
    """--mode train_transformer of a grouped-query model, then --mode
    sample with transformer_checkpoint naming its checkpoint dir: the port's
    own state_dict, qkv of width hidden + 2 kv_heads hd, loads and serves;
    --mode export of the same dir raises."""
    from mas_tpu_torch.cli import main

    monkeypatch.chdir(tmp_path)
    ck = str(tmp_path / "ck")
    transformer = dict(V_TINY, image_tokens_per_dim=2, num_kv_heads=2,
                       kv_cache_dtype="int4")
    train = {"train": {"mode": "train_transformer", "total_steps": 1,
                       "batch_size": 2, "checkpoint_dir": ck},
             "transformer": transformer, "data": {"kind": "synthetic"}}
    path = tmp_path / "train.json"
    path.write_text(json.dumps(train))
    assert main(["--config", str(path), "--device", "cpu"]) == 0
    sample = json.loads(open(_cli_config(tmp_path, "dir")).read())
    sample.update(transformer=transformer, transformer_checkpoint=ck)
    path.write_text(json.dumps(sample))
    assert main(["--config", str(path), "--mode", "sample", "--device",
                 "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert out.endswith("dir.jpg") and os.path.getsize(out) > 0
    with pytest.raises(ValueError, match="GQA"):
        main(["--config", str(path), "--mode", "export", "--device", "cpu"])
