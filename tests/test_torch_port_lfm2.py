"""The hybrid (LFM2-MoE) block in the port against its plain reference,
on the CPU, fp32, with seeded weights.

The model is tiny: 4 layers (conv, conv, attention, conv), the first two
dense, 8 experts with top-2 and a nonzero ``expert_bias``, width 64, 4
query heads over 2 kv heads, the token interface at text 16 + seg 4^2 +
image 8^2 tokens.  The reference (``perfbench/reference/lfm2_moe.py``)
imports no kernel of the port.  Tolerances: 1e-4 on logits where both
sides compute in fp32 (the same products summed in other orders); the
int4 cache is held at 1e-3, since a k or v value that differs in its last
fp32 bit can land on the other side of a rounding boundary of the 15-level
grid, which moves it by a whole step (``test_torch_port_models.py``'s
reason).  In fp32 the port's router chooses the reference's experts at
every position (checked in the forward's test).  The faults (the expert
bias, the weights' normalization, the conv state's write, the RoPE left
out) each move the logits by far more.

Torch runs one thread in this file: the test suite runs in several worker
processes on a few cores, and this model's operations are too small for
more threads to help.
"""

import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

from mas_tpu_torch.models import hybrid
from mas_tpu_torch.models.sampler import sample_tokens
from mas_tpu_torch.models.transformer import MakeAScene
from mas_tpu_torch.ops import moe
from mas_tpu_torch.train.state import Adam
from mas_tpu_torch.train.steps import make_transformer_train_step
from mas_tpu_torch.utils.config import (ConfigError, HybridBlockConfig,
                                        TransformerConfig, VQModelConfig)
from perfbench.reference import lfm2_moe as ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_CFG = dict(num_layers=4, hidden_dim=64, num_attn_heads=4, num_kv_heads=2,
             image_vocab_size=96, seg_vocab_size=32, text_vocab_size=88,
             image_tokens_per_dim=8, seg_tokens_per_dim=4, text_length=16)
B_CFG = dict(layer_types=["conv", "conv", "full_attention", "conv"],
             intermediate_size=128, moe_intermediate_size=64, num_experts=8,
             num_experts_per_tok=2, num_dense_layers=2)
ATOL, ATOL_INT4 = 1e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(g, seed):
    gen = torch.Generator().manual_seed(seed)
    return {name: torch.randn(shape, generator=gen) * std + mean
            for name, shape, mean, std, _ in ref.param_spec(g)}


def _model(cache="int4", seed=3):
    t = TransformerConfig(**T_CFG, kv_cache_dtype=cache)
    b = HybridBlockConfig(**B_CFG)
    model = MakeAScene(t, fp32_params=True, block=b).eval()
    g = ref.Geometry.of(dict(T_CFG, kv_cache_dtype=cache), B_CFG)
    P = _weights(g, seed)
    model.load_state_dict(P, strict=True)
    return model, g, P


def _tokens(seed=1, b=2):
    r = np.random.default_rng(seed)
    c = T_CFG
    text = r.integers(1, c["text_vocab_size"] - c["text_length"],
                      (b, c["text_length"]))
    text[:, -4:] = 0                             # the pad remap
    seg = r.integers(0, c["seg_vocab_size"], (b, c["seg_tokens_per_dim"] ** 2))
    img = r.integers(0, c["image_vocab_size"],
                     (b, c["image_tokens_per_dim"] ** 2))
    return (torch.from_numpy(a) for a in (text, seg, img))


def _ref_logits(P, g, text, seg, img, int4):
    """The reference's logits at the image positions, teacher-forced, and
    the experts it chose [B, T, MoE layers, k]."""
    n = g.image_length
    h, chosen, _ = ref.hidden(P, g, text, seg, img[:, :-1], int4_cache=int4)
    return ref.logits(P, g, h[:, g.prefix - 1:g.prefix - 1 + n]), chosen


def _decoded(model, text, seg, img):
    """Prefill, then a decode step for every image token but the last:
    the logits [B, image_length, vocab] each step returns."""
    with torch.no_grad():
        first, seeds = model.prefill(text, seg)
        caches = model.allocate_caches(seeds, text.shape[0])
        out = [first]
        for step in range(img.shape[1] - 1):
            out.append(model.decode_step(img[:, step:step + 1], step, caches))
    return torch.stack(out, dim=1)


def test_forward_logits_and_routing_match_the_reference():
    model, g, P = _model("compute")
    text, seg, img = _tokens()
    calls = []
    inner = moe.route

    def route(*args):
        idx, w = inner(*args)
        calls.append(idx)
        return idx, w

    with torch.no_grad(), mock.patch.object(moe, "route", route):
        got = model(text, seg, img)
    want, chosen = _ref_logits(P, g, text, seg, img, int4=False)
    t = chosen.shape[1]
    port = torch.stack(calls).view(len(calls), 2, -1, 2)[:, :, :t]
    assert torch.equal(port.permute(1, 2, 0, 3).sort(-1).values,
                       chosen.sort(-1).values)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("cache,atol", [("compute", ATOL),
                                        ("int4", ATOL_INT4)])
def test_prefill_and_decode_match_the_teacher_forced_reference(cache, atol):
    """Prefill and 63 decode steps through the float or int4 caches and
    the conv states against the reference's whole sequence."""
    model, g, P = _model(cache)
    text, seg, img = _tokens(seed=4)
    got = _decoded(model, text, seg, img)
    want, _ = _ref_logits(P, g, text, seg, img, int4=cache == "int4")
    assert got.shape == (2, 64, 96)
    torch.testing.assert_close(got, want, atol=atol, rtol=0)


def test_routing_chooses_by_the_biased_score_and_weights_without_it():
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(64, 8, generator=g)
    bias = torch.randn(8, generator=g)
    idx, w = moe.route(logits, bias, 2, True, 1.0)
    s = torch.sigmoid(logits)
    want_idx = torch.topk(s + bias, 2).indices
    assert torch.equal(idx, want_idx)
    assert not torch.equal(idx, torch.topk(s, 2).indices)   # bias matters
    want_w = s.gather(1, want_idx)
    torch.testing.assert_close(w, want_w / (want_w.sum(1, keepdim=True)
                                            + 1e-6))
    P = {"f.gate": torch.eye(8), "f.expert_bias": bias}
    geo = ref.Geometry.of(T_CFG, B_CFG)
    r_idx, r_w, deficit = ref.route(P, "f.", logits, geo)
    assert torch.equal(r_idx, idx) and torch.allclose(r_w, w)
    assert not deficit.any()
    # another router's choice: the reference takes it, weights it by the
    # scores alone, and reports how far it falls short of its own
    other = torch.topk(s, 2).indices
    o_idx, o_w, short = ref.route(P, "f.", logits, geo, chosen=other)
    assert torch.equal(o_idx, other)
    o_s = s.gather(1, other)
    torch.testing.assert_close(o_w, o_s / (o_s.sum(1, keepdim=True) + 1e-6))
    kth = torch.topk(s + bias, 2).values[:, -1]
    torch.testing.assert_close(
        short, (kth - (s + bias).gather(1, other).amin(1)).clamp_min(0))
    assert (short > 0).any()


def test_grouping_orders_pairs_by_expert_stably():
    idx = torch.tensor([[3, 0], [0, 2], [3, 1], [0, 3]])
    groups = moe.group(idx, 5)
    assert groups.offsets.tolist() == [0, 3, 4, 5, 8, 8]
    assert groups.counts.tolist() == [3, 1, 1, 3, 0]
    assert groups.order.tolist() == [1, 2, 6, 5, 3, 0, 4, 7]


def test_b12_twin_matches_a_per_token_loop():
    gen = torch.Generator().manual_seed(1)
    t, d, f, e, k = 40, 32, 48, 6, 3
    x = torch.randn(t, d, generator=gen)
    w1, w3 = (torch.randn(e, f, d, generator=gen) * 0.1 for _ in range(2))
    w2 = torch.randn(e, d, f, generator=gen) * 0.1
    idx = torch.stack([torch.randperm(e, generator=gen)[:k]
                       for _ in range(t)])
    w = torch.rand(t, k, generator=gen)
    got = moe.expert_swiglu(x, w1, w3, w2, moe.group(idx, e), w, k)
    want = torch.zeros(t, d)
    for i in range(t):
        for j in range(k):
            ex = int(idx[i, j])
            h = torch.nn.functional.silu(w1[ex] @ x[i]) * (w3[ex] @ x[i])
            want[i] += w[i, j] * (w2[ex] @ h)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def _int_step(model, img_token, step, caches):
    """The decode step with a host position: embeddings at ``arange``, the
    index from ``torch.full``."""
    cfg = model.cfg
    n = cfg.image_tokens_per_dim
    pos = torch.arange(step, step + 1)
    x = (model.image_token_embedding(img_token.long())
         + model.image_row_embeddings(pos // n)
         + model.image_col_embeddings(pos % n))
    index = torch.full((1,), cfg.prefix_length + step, dtype=torch.int32)
    for layer, state in zip(model.transformer.layers, caches):
        x = layer.decode(x, state, index)
    return model._logits(model._final_ln(x))[:, 0]


def _state(caches):
    return [t for state in caches for t in state.tensors()]


def test_device_position_body_is_bitwise_the_int_step():
    """``decode_body`` at one persistent step tensor, as a replay sees it,
    gives the int-step path's logits and states bit for bit; running a
    step twice at one position leaves the conv states as once."""
    model, _, _ = _model("int4")
    text, seg, img = _tokens(seed=5)
    pos = torch.zeros(1, dtype=torch.int32)
    with torch.inference_mode():
        _, seeds = model.prefill(text, seg)
        got_c = model.allocate_caches(seeds, 2)
        want_c = model.allocate_caches(seeds, 2)
        for step in range(img.shape[1] - 1):
            tok = img[:, step:step + 1]
            pos.fill_(step)
            got = model.decode_body(tok, pos, got_c)
            if step == 3:                      # the capture's warm-up
                got = model.decode_body(tok, pos, got_c)
            want = _int_step(model, tok, step, want_c)
            assert torch.equal(got, want), f"step {step}"
            assert all(torch.equal(a, b) for a, b in
                       zip(_state(got_c), _state(want_c))), f"step {step}"


def test_sampling_counts_the_routed_pairs_and_seeds_conv_states():
    model, _, _ = _model("int4")
    text, seg, _ = _tokens(seed=6)
    before = model.routed_pairs().clone()
    toks = sample_tokens(model, text, seg, torch.Generator().manual_seed(0),
                         guidance_scale=3.0, top_k=4)
    assert toks.shape == (2, 64)
    got = model.routed_pairs() - before              # [layers, 2, E + 3]
    rows, k = 4, 2                                   # guided: 2 x 2 rows
    assert got.shape == (2, 2, 11)
    assert (got[:, 0, :8].sum(-1) == rows * 32 * k).all()   # prefill
    assert (got[:, 1, :8].sum(-1) == rows * 63 * k).all()   # decode
    assert (got[:, :, 9] == torch.tensor([1, 63])).all()    # calls
    assert (got[:, :, 8] <= got[:, :, 9] * 8).all()         # active
    busiest = got[:, :, 10]                  # >= the mean, <= all pairs
    assert (busiest * 8 >= got[:, :, :8].sum(-1)).all()
    assert (busiest <= got[:, :, :8].sum(-1)).all()
    with torch.inference_mode():
        _, seeds = model.prefill(text, seg)
        caches = model.allocate_caches(seeds, 2)
    kinds = [type(state).__name__ for state in caches]
    assert kinds == ["ConvState", "ConvState", "LaneState", "ConvState"]
    assert caches[0].data.shape == (2, 3, 64)


def test_state_seed_span_sits_in_cache_seed():
    from mas_tpu_torch.utils import spans

    model, _, _ = _model("int4")
    text, seg, _ = _tokens(seed=7)
    spans.enable(True)
    try:
        with torch.inference_mode():
            _, seeds = model.prefill(text, seg)
            model.allocate_caches(seeds, 2)
    finally:
        spans.enable(False)
    got = {r.name: r for r in spans.drain()}
    assert got["state_seed"].parent == got["cache_seed"].id


def _moved(monkeypatch, fault):
    """The largest gap of the port's int4 decode logits from the
    reference's with ``fault`` planted in the port."""
    model, g, P = _model("int4")
    text, seg, img = _tokens(seed=4)
    fault(monkeypatch)
    got = _decoded(model, text, seg, img)
    want, _ = _ref_logits(P, g, text, seg, img, int4=True)
    return float((got - want).abs().max())


def _bias_dropped(mp):
    inner = moe.route
    mp.setattr(moe, "route", lambda lg, bias, *a: inner(lg, None, *a))


def _unnormalized(mp):
    inner = moe.route
    mp.setattr(moe, "route", lambda lg, bias, k, norm, scale:
               inner(lg, bias, k, False, scale))


def _conv_state_frozen(mp):
    def frozen(self, h, state, index):
        data = state.data
        state = hybrid.ConvState(data.clone())
        return inner(self, h, state, index)
    inner = hybrid.ShortConv.decode
    mp.setattr(hybrid.ShortConv, "decode", frozen)


def _rope_dropped(mp):
    mp.setattr(hybrid, "rope", lambda x, cos, sin: x)


@pytest.mark.parametrize("fault", [_bias_dropped, _unnormalized,
                                   _conv_state_frozen, _rope_dropped])
def test_faults_leave_the_reference(monkeypatch, fault):
    # ten times the tolerance the sound port is held to (dropping the
    # normalization is the weakest: top-2 sigmoid scores near 0.5 sum to
    # about 1 at this size, and it reads 0.0156)
    assert _moved(monkeypatch, fault) > 10 * ATOL_INT4


def test_tensor_parallel_and_training_are_refused():
    t = TransformerConfig(**T_CFG, kv_cache_dtype="int4")
    b = HybridBlockConfig(**B_CFG)
    with pytest.raises(ConfigError, match="mesh.model 2"):
        MakeAScene(t, shard=(0, 2), block=b)
    model = MakeAScene(t, fp32_params=True, block=b)
    with pytest.raises(NotImplementedError, match="ROADMAP M2"):
        make_transformer_train_step(model, Adam(
            model.named_parameters(), 1e-4, 0.9, 0.95, 1e-8))
    with pytest.raises(ConfigError, match="layer_types"):
        HybridBlockConfig(**dict(B_CFG, layer_types=["conv", "mamba"]))
    with pytest.raises(ConfigError, match="num_layers"):
        MakeAScene(TransformerConfig(**dict(T_CFG, num_layers=3)), block=b)
    with pytest.raises(ConfigError, match="packed"):
        MakeAScene(TransformerConfig(**T_CFG, kv_cache_dtype="int4",
                                     kv_cache_layout="packed"), block=b)


def test_shipped_configs_still_load_and_the_lfm2_config_is_the_catalogs():
    for name in sorted(os.listdir(os.path.join(ROOT, "configs"))):
        with open(os.path.join(ROOT, "configs", name)) as f:
            raw = json.load(f)
        if "transformer" in raw:
            TransformerConfig.from_dict(raw["transformer"])
        if "model" in raw:
            VQModelConfig.from_dict(raw["model"])
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "lfm2_8b_a1b_256.json")) as f:
        raw = json.load(f)
    t = TransformerConfig.from_dict(raw["transformer"])
    b = HybridBlockConfig.from_dict(raw["block"])
    b.check(t)
    for key, value in raw["block"].items():
        assert raw[key] == value, key
    assert (t.hidden_dim, t.num_layers, t.num_attn_heads, t.num_kv_heads) == (
        raw["hidden_size"], raw["num_hidden_layers"],
        raw["num_attention_heads"], raw["num_key_value_heads"])
    assert b.attention_layers == (2, 6, 10, 14, 18, 21)
    assert t.head_dim == raw["assumed"]["head_dim"] == 64
