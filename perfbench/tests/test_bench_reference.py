"""The frozen references against the program's plain path, at a tiny
width on the CPU, fp32: the same weights give the same answers."""

import pytest
import torch

from mas_tpu_torch.models.transformer import MakeAScene
from mas_tpu_torch.models.vqvae import VQModel
from mas_tpu_torch.train.state import make_adam
from mas_tpu_torch.train.steps import transformer_loss_and_grads
from mas_tpu_torch.utils.config import (OptimizerConfig, TransformerConfig,
                                        VQModelConfig)
from perfbench import weights
from perfbench.reference import precision
from perfbench.reference import transformer as ref_t
from perfbench.reference import vqvae as ref_v
from perfbench.tests import tiny

F32 = {"dense": torch.float32, "norm": torch.float32, "conv": torch.float32,
       "fp32": torch.float32}


def _transformer(**over):
    t = dict(tiny.TRANSFORMER, compute_dtype="float32", **over)
    g = ref_t.Geometry.of(t)
    p = weights.make(ref_t.param_spec(g), 7, "cpu", F32)
    model = MakeAScene(TransformerConfig.from_dict(t), fp32_params=True)
    model.load_state_dict(p)
    return g, p, model


def _tokens(g, b=2, seed=0):
    gen = torch.Generator().manual_seed(seed)
    text = torch.randint(1, g.text_vocab - g.text_length, (b, g.text_length),
                         generator=gen)
    text[:, 3:] = 0
    seg = torch.randint(0, g.seg_vocab, (b, g.seg_side ** 2), generator=gen)
    img = torch.randint(0, g.image_vocab, (b, g.image_length), generator=gen)
    return text, seg, img


def test_spec_is_the_programs_state_dict():
    g, _, model = _transformer()
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == {n: s for n, s, *_ in ref_t.param_spec(g)}
    vq = VQModel(VQModelConfig.from_dict(tiny.MODEL))
    mine = {n: s for n, s, *_ in ref_v.param_spec(tiny.MODEL)}
    theirs = {k: tuple(v.shape) for k, v in vq.state_dict().items()
              if not k.startswith(("encoder.", "quant_conv."))}
    assert mine == theirs


def test_forward():
    g, p, model = _transformer()
    text, seg, img = _tokens(g)
    with torch.no_grad():
        want = model(text, seg, img)
        h = ref_t.hidden(p, g, text, seg, img)
        got = ref_t.logits(p, g, h[:, -g.image_length - 1:-1])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_decode_through_the_int4_cache():
    # the program's prefill and teacher-forced decode steps over its int4
    # lane cache against the reference's modelled cache
    g, p, model = _transformer(kv_cache_dtype="int4")
    text, seg, img = _tokens(g)
    with torch.no_grad():
        logits, kvs = model.prefill(text, seg)
        caches = model.allocate_caches(kvs, text.shape[0])
        steps = [logits]
        for s in range(g.image_length - 1):
            steps.append(model.decode_step(img[:, s:s + 1], s, caches))
        want = torch.stack(steps, dim=1)
        h = ref_t.hidden(p, g, text, seg, img[:, :-1], int4_cache=True)
        got = ref_t.logits(p, g, h[:, g.prefix - 1:])
        exact = ref_t.logits(p, g, ref_t.hidden(
            p, g, text, seg, img[:, :-1])[:, g.prefix - 1:])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert (exact - want).abs().max() > 10 * (got - want).abs().max()


def test_guided_serve_logits():
    g, p, model = _transformer(kv_cache_dtype="int4")
    text, seg, img = _tokens(g, b=1)
    with torch.no_grad():
        guided = ref_t.serve_logits(p, g, text, seg, img, 3.0)
        both = []
        for t in (text, torch.zeros_like(text)):
            h = ref_t.hidden(p, g, t, seg, img[:, :-1], int4_cache=True)
            both.append(ref_t.logits(p, g, h[:, g.prefix - 1:]))
    torch.testing.assert_close(guided, both[1] + 3.0 * (both[0] - both[1]))


def test_vq_decode():
    m = dict(tiny.MODEL, compute_dtype="float32")
    p = weights.make(ref_v.param_spec(m), 3, "cpu", F32)
    vq = VQModel(VQModelConfig.from_dict(m)).eval()
    vq.load_state_dict(p, strict=False)
    idx = torch.randint(0, 64, (2, 4, 4))
    with torch.no_grad():
        torch.testing.assert_close(ref_v.decode_code(p, m, idx),
                                   vq.decode_code(idx), rtol=1e-4, atol=1e-4)


def test_train_steps():
    g, p, model = _transformer()
    text, seg, img = _tokens(g, b=3)
    adam = ref_t.Adam(4.5e-3, 0.9, 0.95, 1e-8)
    losses, first, end = ref_t.train_steps(
        p, g, [(text, seg, img)] * 2, [False, True], adam)
    opt = make_adam(OptimizerConfig(lr=4.5e-3, beta1=0.9, beta2=0.95),
                    model.named_parameters(), rescale_lr=False)
    want = []
    for k, t in enumerate((text, torch.zeros_like(text))):
        loss, grads = transformer_loss_and_grads(model, t, seg, img)
        want.append(loss.item())
        if k == 0:
            for (name, _), gr in zip(model.named_parameters(), grads):
                torch.testing.assert_close(first[name], gr, rtol=1e-4,
                                           atol=1e-7)
        opt.step(grads)
    assert losses == pytest.approx(want, rel=1e-5)
    # Adam moves an element with a gradient at rounding by +-lr either
    # way, so a few elements differ: hold the whole change
    for name, param in model.named_parameters():
        change = (param.detach() - p[name]).norm()
        assert (end[name] - param.detach()).norm() <= 1e-2 * change, name


def test_leaves_split_the_fused_projection():
    t = torch.arange(12.0).reshape(6, 2)
    parts = ref_t.leaves("transformer.layers.0.attn.qkv.weight", t)
    assert [n for n, _ in parts] == [
        f"transformer.layers.0.attn.qkv.weight[{c}]" for c in "qkv"]
    assert torch.equal(torch.cat([x for _, x in parts]), t)
    assert len(ref_t.leaves("to_logits.1.weight", t)) == 1


def test_fp8_rounds_and_passes_gradients():
    x = torch.randn(64, requires_grad=True)
    y = precision.fp8(x)
    rel = ((y - x).abs() / x.abs().max()).max()
    assert 0 < rel < 2 ** -4
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones(64))
