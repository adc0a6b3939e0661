"""Port models vs the JAX package, on CPU, with the same weights.

The JAX modules are initialized from a seed, their parameter trees go
through the port's weight bridge (``mas_tpu_torch.utils.weights``) and load
with ``strict=True``; both packages then see the same numpy inputs.  fp32
throughout.  Tolerances: 1e-4 for the VQ decoder and the full-sequence
logits (fp32 convolutions and matmuls summed in other orders); 1e-3 for
teacher-forced decode over int8 caches; the int4 case is looser because a
k/v value that differs in its last fp32 bit between the two packages can
land on the other side of a rounding boundary of the 15-level grid, which
moves that value by a whole quantization step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mas_tpu.models.transformer import MakeAScene as JMakeAScene
from mas_tpu.models.vqvae import VQModel as JVQModel
from mas_tpu.ops.decode_attention import transpose_cache
from mas_tpu.ops.quant import QuantCache as JQuantCache
from mas_tpu.ops.quant import quantize_kv as jquantize_kv
from mas_tpu.utils.config import CodebookConfig as JCodebookConfig
from mas_tpu.utils.config import TransformerConfig as JTransformerConfig
from mas_tpu.utils.config import VQModelConfig as JVQModelConfig
from mas_tpu.utils.torch_export import export_vqbase_state

from mas_tpu_torch.models.transformer import MakeAScene
from mas_tpu_torch.models.vqvae import VQModel
from mas_tpu_torch.utils.config import TransformerConfig, VQModelConfig
from mas_tpu_torch.utils.weights import (load_reference_pt, serving_state,
                                         transformer_from_flax, vq_from_flax)

VQ_TINY = dict(channels=(32, 32, 64), resolution=32, attn_resolutions=(16,),
               z_channels=32, embed_dim=16, num_res_blocks=1,
               codebook=dict(codebook_size=64, codebook_dim=16,
                             reservoir_size=64))

T_TINY = dict(num_layers=2, hidden_dim=128, num_attn_heads=2,
              image_vocab_size=96, seg_vocab_size=32, text_vocab_size=72,
              image_tokens_per_dim=4, seg_tokens_per_dim=4, text_length=8)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _vq_pair(seed=0):
    jcfg = JVQModelConfig(**{**VQ_TINY, "codebook": JCodebookConfig(
        **VQ_TINY["codebook"])})
    jmodel = JVQModel(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(seed),
                            jnp.zeros((1, 32, 32, 3)))
    model = VQModel(VQModelConfig(**VQ_TINY)).eval()
    model.load_state_dict(vq_from_flax(_np_tree(variables), model.cfg),
                          strict=True)
    return jmodel, variables, model


def test_decoder_keys_replay_matches_export():
    jmodel, variables, model = _vq_pair()
    exported = export_vqbase_state(_np_tree(variables), jmodel.cfg)
    assert set(model.state_dict()) == set(exported)
    assert any(k.startswith("encoder.model.") for k in exported)


def test_vq_decode_code_matches_jax():
    jmodel, variables, model = _vq_pair(seed=1)
    idx = np.random.default_rng(0).integers(0, 64, (2, 16, 16))
    ref = jmodel.apply(variables, jnp.asarray(idx, jnp.int32),
                       method=JVQModel.decode_code)
    with torch.no_grad():
        got = model.decode_code(torch.from_numpy(idx))
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_vq_loads_exported_pt_strict(tmp_path):
    """The .pt written by the JAX package's --mode export loads with
    strict=True into the full VQModel, encode side included."""
    from mas_tpu.utils.torch_export import save_torch_checkpoint

    jmodel, variables, model = _vq_pair(seed=2)
    path = str(tmp_path / "vq.pt")
    save_torch_checkpoint(path, export_vqbase_state(_np_tree(variables),
                                                    jmodel.cfg))
    fresh = VQModel(model.cfg)
    fresh.load_state_dict(serving_state(load_reference_pt(path), "vq"),
                          strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_orbax_directory_raises(tmp_path):
    with pytest.raises(ValueError, match="jax"):
        load_reference_pt(str(tmp_path))


# --- transformer -----------------------------------------------------------

def _t_pair(seed=0, **kw):
    cfg = dict(T_TINY, **kw)
    jcfg = JTransformerConfig(**cfg)
    jmodel = JMakeAScene(jcfg)
    variables = jmodel.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, jcfg.text_length), jnp.int32),
        jnp.zeros((1, jcfg.seg_length), jnp.int32),
        jnp.zeros((1, jcfg.image_length), jnp.int32))
    model = MakeAScene(TransformerConfig(**cfg)).eval()
    model.load_state_dict(transformer_from_flax(_np_tree(variables),
                                                model.cfg), strict=True)
    return jmodel, variables, model


def _tokens(cfg, b=2, seed=1):
    r = np.random.default_rng(seed)
    text = r.integers(1, cfg.text_vocab_size - cfg.text_length,
                      (b, cfg.text_length))
    text[:, -3:] = 0                          # exercise the pad remap
    seg = r.integers(0, cfg.seg_vocab_size, (b, cfg.seg_length))
    img = r.integers(0, cfg.image_vocab_size, (b, cfg.image_length))
    return text, seg, img


@pytest.mark.parametrize("flags", [
    dict(), dict(prefix_bidirectional=False),
    dict(cogview_sandwich_layernorm=False)])
def test_forward_and_prefill_logits_match_jax(flags):
    jmodel, variables, model = _t_pair(**flags)
    text, seg, img = _tokens(model.cfg)
    t = lambda a: torch.from_numpy(a)
    j = lambda a: jnp.asarray(a, jnp.int32)
    ref = jmodel.apply(variables, j(text), j(seg), j(img))
    ref0, _ = jmodel.apply(variables, j(text), j(seg),
                           method=JMakeAScene.prefill)
    with torch.no_grad():
        got = model(t(text), t(seg), t(img))
        got0, kvs = model.prefill(t(text), t(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(got0.numpy(), np.asarray(ref0), atol=1e-4)
    assert len(kvs) == model.cfg.num_layers
    assert kvs[0][0].shape == (2, 2, model.cfg.prefix_length, 64)


def _jax_caches(cfg, kvs, bits):
    qdt = jnp.int4 if bits == 4 else jnp.int8
    bb = kvs[0][0].shape[0]
    q_full = jnp.zeros((bb, cfg.num_attn_heads, cfg.head_dim,
                        cfg.total_length), qdt)
    s_full = jnp.ones((bb, cfg.num_attn_heads, 1, cfg.total_length))

    def seed(kv):
        qc = jquantize_kv(transpose_cache(kv), dtype=qdt)
        return JQuantCache(
            jax.lax.dynamic_update_slice(q_full, qc.q, (0, 0, 0, 0)),
            jax.lax.dynamic_update_slice(s_full, qc.scale, (0, 0, 0, 0)))

    return tuple((seed(k), seed(v)) for k, v in kvs)


@pytest.mark.parametrize("cache,atol", [("int8", 1e-3), ("int4", 1e-2)])
def test_teacher_forced_decode_matches_jax(cache, atol):
    jmodel, variables, model = _t_pair(seed=3, kv_cache_dtype=cache)
    cfg = model.cfg
    text, seg, img = _tokens(cfg, seed=4)
    bits = 4 if cache == "int4" else 8
    j = lambda a: jnp.asarray(a, jnp.int32)
    ref0, jkv = jmodel.apply(variables, j(text), j(seg),
                             method=JMakeAScene.prefill)
    jcaches = _jax_caches(jmodel.cfg, jkv, bits)
    step_fn = jax.jit(lambda v, tok, step, c: jmodel.apply(
        v, tok, step, c, method=JMakeAScene.decode_step))
    with torch.no_grad():
        got0, kvs = model.prefill(torch.from_numpy(text),
                                  torch.from_numpy(seg))
        caches = model.allocate_caches(kvs, 2)
        np.testing.assert_allclose(got0.numpy(), np.asarray(ref0),
                                   atol=1e-4)
        for step in range(8):
            tok = img[:, step:step + 1]
            ref, jcaches = step_fn(variables, j(tok), step, jcaches)
            got = model.decode_step(torch.from_numpy(tok), step, caches)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       atol=atol, err_msg=f"step {step}")
    # the caches hold the same quantized prefix + 8 tokens
    upto = cfg.prefix_length + 8
    jk = jcaches[0][0]
    got_vals = caches[0].k.values()[:, :, :upto].numpy()
    ref_vals = np.asarray(jk.q.astype(jnp.int8))[..., :upto].transpose(
        0, 1, 3, 2)
    agree = np.mean(got_vals == ref_vals)
    assert agree > (0.999 if bits == 8 else 0.99), agree


def test_export_pt_loads_into_port_transformer(tmp_path):
    from mas_tpu.utils.torch_export import (export_transformer_state,
                                            save_torch_checkpoint)

    jmodel, variables, model = _t_pair(seed=5)
    path = str(tmp_path / "t.pt")
    save_torch_checkpoint(path, export_transformer_state(
        _np_tree(variables), jmodel.cfg))
    state = load_reference_pt(path)
    state["transformer.mask"] = torch.tril(torch.ones(4, 4))  # reference buffer
    fresh = MakeAScene(model.cfg)
    fresh.load_state_dict(serving_state(state, "transformer"), strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_bf16_model_keeps_norms_fp32():
    model = MakeAScene(TransformerConfig(**T_TINY,
                                         compute_dtype="bfloat16"))
    layer = model.transformer.layers[0]
    assert layer.attn.qkv.weight.dtype == torch.bfloat16
    assert model.image_token_embedding.weight.dtype == torch.bfloat16
    assert layer.ln_in.weight.dtype == torch.float32
    vq = VQModel(VQModelConfig(**VQ_TINY, compute_dtype="bfloat16"))
    assert vq.post_quant_conv.weight.dtype == torch.bfloat16
    assert vq.quantize.embedding.weight.dtype == torch.float32
