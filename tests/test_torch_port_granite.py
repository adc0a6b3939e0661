"""The Granite 4.0-H hybrid block in the port against its plain reference,
on the CPU, fp32, with seeded weights.

The model is tiny: 3 layers (Mamba2, attention, Mamba2), width 64; the
Mamba2 layers 4 heads of 16 (``mamba_expand`` 1) with a state of 16 and a
conv of 4 taps, scanned in chunks of 8 so that the 32-token prefix takes
four chunks and a whole sequence twelve; 4 query heads over 2 kv heads;
8 experts of 32 with top-2 and a shared expert of 48; the token interface
at text 16 + seg 4^2 + image 8^2 tokens.  The reference
(``perfbench/reference/granite_hybrid.py``) imports no kernel of the port
and runs the state's recurrence position by position.

The products' weights are drawn 8 times wider than the reference's stds
(``WIDEN``, the square root of the fan-in's ratio, 4096 / 64), so that
the activations have the sizes they have at the published width: at
std 0.02 the tiny model's SSM state and shared expert add a few tenths of
a percent to the logits, and leaving either out would hide in rounding.

Tolerances, each relative to the reference's largest logit (the head
divides the logits by ``logits_scaling``, so they are ~0.04 here): 1e-4
where both sides compute in fp32 (the chunked scan and the recurrence
sum the same products in other orders, as do the batched and
per-position products; ~6e-7 read); the int4 cache at 1e-3, since a k or
v value that differs in its last fp32 bit can land on the other side of
a rounding boundary of the 15-level grid, which moves it by a whole step
(``test_torch_port_lfm2.py``'s reason); the scan and the states at 1e-5
relative to their largest value (fp32 sums of a few hundred terms of
size ~1).  In fp32 the port's router chooses the reference's experts at
every position (checked in the forward's test).  Each of the seven
planted faults moves the logits by at least ten times the int4
tolerance (the weakest, the state frozen, by a third of the largest
logit).

Torch runs one thread in this file, as in ``test_torch_port_lfm2.py``.
"""

import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

from mas_tpu_torch.models import hybrid
from mas_tpu_torch.models.decode_state import MambaState
from mas_tpu_torch.models.sampler import sample_tokens
from mas_tpu_torch.models.transformer import MakeAScene
from mas_tpu_torch.ops import moe, ssm
from mas_tpu_torch.train.state import Adam
from mas_tpu_torch.train.steps import make_transformer_train_step
from mas_tpu_torch.utils.config import (ConfigError, GraniteBlockConfig,
                                        TransformerConfig)
from perfbench.reference import granite_hybrid as ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_CFG = dict(num_layers=3, hidden_dim=64, num_attn_heads=4, num_kv_heads=2,
             image_vocab_size=96, seg_vocab_size=32, text_vocab_size=88,
             image_tokens_per_dim=8, seg_tokens_per_dim=4, text_length=16)
B_CFG = dict(layer_types=["mamba", "attention", "mamba"],
             intermediate_size=32, shared_intermediate_size=48,
             num_local_experts=8, num_experts_per_tok=2, mamba_n_heads=4,
             mamba_d_head=16, mamba_d_state=16, mamba_expand=1,
             mamba_chunk_size=8, attention_multiplier=0.0625)
ATOL, ATOL_INT4, REL = 1e-4, 1e-3, 1e-5
WIDEN = 8.0       # sqrt(4096 / 64): the products' fan-in, published / here


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(g, seed):
    """The reference's weights, the products' drawn WIDEN times wider, so
    that at width 64 the activations have the sizes they have at 4096."""
    gen = torch.Generator().manual_seed(seed)
    return {name: ref.draw(shape, mean, std * (
        WIDEN if ("_proj." in name or "experts." in name
                  or "shared." in name) else 1.0), role, gen, "cpu")
            for name, shape, mean, std, role in ref.param_spec(g)}


def _model(cache="int4", seed=3):
    t = TransformerConfig(**T_CFG, kv_cache_dtype=cache)
    b = GraniteBlockConfig(**B_CFG)
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
    the experts it chose [B, T, layers, k]."""
    n = g.image_length
    h, chosen, _, _ = ref.hidden(P, g, text, seg, img[:, :-1],
                                 int4_cache=int4)
    return ref.logits(P, g, h[:, g.prefix - 1:g.prefix - 1 + n]), chosen


def _decoded(model, text, seg, img):
    """Prefill, then a decode step for every image token but the last:
    the logits [B, image_length, vocab] each step returns."""
    with torch.no_grad():
        first, seeds = model.prefill(text, seg)
        caches = model.allocate_caches(seeds, text.shape[0])
        del seeds
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
    torch.testing.assert_close(got, want, rtol=0,
                               atol=ATOL * float(want.abs().max()))


@pytest.mark.parametrize("cache,atol", [("compute", ATOL),
                                        ("int4", ATOL_INT4)])
def test_prefill_and_decode_match_the_teacher_forced_reference(cache, atol):
    """Prefill (the chunked scan) and 63 decode steps through the Mamba2
    states (B14's twin) and the float or int4 cache against the
    reference's recurrence over the whole sequence."""
    model, g, P = _model(cache)
    text, seg, img = _tokens(seed=4)
    got = _decoded(model, text, seg, img)
    want, _ = _ref_logits(P, g, text, seg, img, int4=cache == "int4")
    assert got.shape == (2, 64, 96)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=atol * float(want.abs().max()))


def _recurrence(x, dt, a, b, c):
    """The scan as defined, position by position (no D skip)."""
    s = x.new_zeros(x.shape[0], x.shape[2], x.shape[3], b.shape[-1])
    ys = []
    for i in range(x.shape[1]):
        s = (torch.exp(dt[:, i] * a)[..., None, None] * s
             + (dt[:, i, :, None] * x[:, i])[..., None]
             * b[:, i, None, None, :])
        ys.append((s * c[:, i, None, None, :]).sum(-1))
    return torch.stack(ys, dim=1), s


def _scan_inputs(seed, r=3, t=37, h=4, p=8, n=12):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(r, t, h, p, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(r, t, h, generator=gen)
                                      - 2.0)
    a = -torch.rand(h, generator=gen) * 15.0 - 1.0
    b, c = (torch.randn(r, t, n, generator=gen) for _ in range(2))
    return x, dt, a, b, c


@pytest.mark.parametrize("chunk", [1, 5, 8, 64])
def test_chunked_scan_matches_the_recurrence(chunk):
    x, dt, a, b, c = _scan_inputs(0)
    y, s = ssm.ssd_chunked(x, dt, a, b, c, chunk)
    want_y, want_s = _recurrence(x, dt, a, b, c)
    for got, want in ((y, want_y), (s, want_s)):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=REL * float(want.abs().max()))


def test_b14_twin_advances_the_state_as_the_recurrence():
    """``ssm_update`` (the plain twin on the CPU) step by step from the
    chunked scan's state after a prefix: each step's y (with the D skip)
    and the state after the last step against the recurrence."""
    x, dt, a, b, c = _scan_inputs(1)
    d = torch.randn(4)
    split = 29
    _, state = ssm.ssd_chunked(x[:, :split], dt[:, :split], a, b[:, :split],
                               c[:, :split], 8)
    want_y, want_s = _recurrence(x, dt, a, b, c)
    for i in range(split, x.shape[1]):
        xbc = torch.cat([x[:, i].flatten(1), b[:, i], c[:, i]], dim=1)
        y = ssm.ssm_update(state, xbc, dt[:, i].contiguous(), a, d)
        want = (want_y[:, i] + d[:, None] * x[:, i]).flatten(1)
        torch.testing.assert_close(y, want, rtol=0,
                                   atol=REL * float(want.abs().max()))
    torch.testing.assert_close(state, want_s, rtol=0,
                               atol=REL * float(want_s.abs().max()))


def test_seeded_states_are_the_reference_states_at_the_prefix_end():
    """The prefill's seeds become each Mamba2 layer's state (taken over,
    no copy): the SSM state equals the reference's after the 32-token
    prefix, the conv ring holds the last K - 1 prefix positions' xBC in
    slots p % K; the attention layer's state is the lane cache."""
    model, g, P = _model("int4")
    text, seg, _ = _tokens(seed=5)
    with torch.no_grad():
        _, seeds = model.prefill(text, seg)
        caches = model.allocate_caches(seeds, 2)
        _, _, _, states = ref.hidden(P, g, text, seg, seg[:, :0])
    assert [type(s).__name__ for s in caches] == ["MambaState", "LaneState",
                                                  "MambaState"]
    assert caches[0].ssm is seeds[0][0] and caches[2].conv is seeds[2][1]
    for state, want in zip((caches[0], caches[2]), states):
        assert state.ssm.shape == (2, 4, 16, 16)
        torch.testing.assert_close(state.ssm, want, rtol=0,
                                   atol=REL * float(want.abs().max()))
    # the ring: xBC of positions 29, 30, 31 in slots 1, 2, 3; slot 0 (for
    # position 32, the first decode step) still zero
    mixer = model.transformer.layers[0].mamba
    with torch.no_grad():
        x = model._scaled(model.embed_prefix(text, seg))
        h = model.transformer.layers[0].operator_norm(x.float())
        _, xbc, _ = mixer._split(h)
    ring = caches[0].conv
    assert ring.shape == (2, 4, 64 + 2 * 16)
    assert torch.equal(ring[:, 1:], xbc[:, 29:32])
    assert not ring[:, 0].any()


def test_softmax_route_takes_the_top_logits_and_weights_over_them():
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(64, 8, generator=gen)
    idx, w = moe.route(logits, None, 3, False, 1.0, "softmax")
    top = torch.topk(logits, 3)
    assert torch.equal(idx, top.indices)
    torch.testing.assert_close(w, torch.softmax(top.values, dim=-1))
    torch.testing.assert_close(w.sum(-1), torch.ones(64))
    # the reference, with its own choice and with another router's
    P = {"f.gate": torch.eye(8)}
    geo = ref.Geometry.of(T_CFG, dict(B_CFG, num_experts_per_tok=3))
    r_idx, r_w, deficit = ref.route(P, "f.", logits, geo)
    assert torch.equal(r_idx, idx) and torch.allclose(r_w, w)
    assert not deficit.any()
    runner_up = torch.topk(logits, 4).indices[:, [0, 1, 3]]
    o_idx, o_w, short = ref.route(P, "f.", logits, geo, chosen=runner_up)
    assert torch.equal(o_idx, runner_up)
    torch.testing.assert_close(
        o_w, torch.softmax(logits.gather(1, runner_up), dim=-1))
    torch.testing.assert_close(
        short, top.values[:, -1] - logits.gather(1, runner_up).amin(1))
    assert (short > 0).all()


def test_sampling_counts_the_routed_pairs_of_every_layer():
    model, _, _ = _model("int4")
    text, seg, _ = _tokens(seed=6)
    before = model.routed_pairs().clone()
    toks = sample_tokens(model, text, seg, torch.Generator().manual_seed(0),
                         guidance_scale=3.0, top_k=4)
    assert toks.shape == (2, 64)
    got = model.routed_pairs() - before              # [layers, 2, E + 3]
    rows, k = 4, 2                                   # guided: 2 x 2 rows
    assert got.shape == (3, 2, 11)
    assert (got[:, 0, :8].sum(-1) == rows * 32 * k).all()   # prefill
    assert (got[:, 1, :8].sum(-1) == rows * 63 * k).all()   # decode
    assert (got[:, :, 9] == torch.tensor([1, 63])).all()    # calls


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


# --- planted faults: each plants into a built model ---------------------

def _mambas(model):
    return [layer.mixer for layer in model.transformer.layers
            if isinstance(layer.mixer, hybrid.Mamba2)]


def _state_frozen(model, mp):
    inner = hybrid.Mamba2.decode
    mp.setattr(hybrid.Mamba2, "decode", lambda self, h, state, index: inner(
        self, h, MambaState(state.ssm.clone(), state.conv), index))


def _d_dropped(model, mp):
    for m in _mambas(model):
        m.D.data.zero_()


def _gate_dropped(model, mp):
    mp.setattr(hybrid.Mamba2, "gate_out",
               lambda self, y, z: self.out_proj(self.norm(y)))


def _conv_bias_dropped(model, mp):
    for m in _mambas(model):
        m.conv1d.bias.data.zero_()


def _shared_expert_dropped(model, mp):
    for layer in model.transformer.layers:
        layer.feed_forward.shared.w2.weight.data.zero_()


def _residual_multiplier_dropped(model, mp):
    for layer in model.transformer.layers:
        layer.residual = 1.0


def _runner_up_set(model, mp):
    def route(logits, bias, k, normalize, scale, score="sigmoid"):
        top = logits.float().topk(k + 1, dim=-1)
        idx = torch.cat([top.indices[:, :k - 1], top.indices[:, k:]], dim=1)
        return idx, torch.softmax(logits.float().gather(1, idx), dim=-1)
    mp.setattr(moe, "route", route)


FAULTS = [_state_frozen, _d_dropped, _gate_dropped, _conv_bias_dropped,
          _shared_expert_dropped, _residual_multiplier_dropped,
          _runner_up_set]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__[1:])
def test_faults_leave_the_reference(monkeypatch, fault):
    """The largest gap of the port's int4 decode logits from the
    reference's, with the fault planted in the port: ten times the
    tolerance that the sound port is held to."""
    model, g, P = _model("int4")
    text, seg, img = _tokens(seed=4)
    fault(model, monkeypatch)
    got = _decoded(model, text, seg, img)
    want, _ = _ref_logits(P, g, text, seg, img, int4=True)
    assert float((got - want).abs().max()) > 10 * ATOL_INT4 * float(
        want.abs().max())


def test_configs_refused():
    t = TransformerConfig(**T_CFG, kv_cache_dtype="int4")
    b = GraniteBlockConfig(**B_CFG)
    with pytest.raises(ConfigError, match="mesh.model 2"):
        MakeAScene(t, shard=(0, 2), block=b)
    model = MakeAScene(t, fp32_params=True, block=b)
    with pytest.raises(NotImplementedError, match="ROADMAP M2"):
        make_transformer_train_step(model, Adam(
            model.named_parameters(), 1e-4, 0.9, 0.95, 1e-8))
    for over, match in (
            (dict(layer_types=["mamba", "conv", "mamba"]), "layer_types"),
            (dict(position_embedding_type="rope"), "nope"),
            (dict(mamba_n_groups=2), "mamba_n_groups"),
            (dict(mamba_conv_bias=False), "mamba_conv_bias"),
            (dict(mamba_proj_bias=True), "bias"),
            (dict(num_experts_per_tok=9), "num_experts_per_tok")):
        with pytest.raises(ConfigError, match=match):
            GraniteBlockConfig(**dict(B_CFG, **over))
    with pytest.raises(ConfigError, match="num_layers"):
        MakeAScene(TransformerConfig(**dict(T_CFG, num_layers=4)), block=b)
    with pytest.raises(ConfigError, match="mamba_expand"):
        MakeAScene(t, block=GraniteBlockConfig(**dict(B_CFG,
                                                      mamba_expand=2)))
    with pytest.raises(ConfigError, match="packed"):
        MakeAScene(TransformerConfig(**T_CFG, kv_cache_dtype="int4",
                                     kv_cache_layout="packed"), block=b)


def test_the_granite_config_is_the_catalogs_cut_to_one_period():
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "granite_4h_small_256.json")) as f:
        raw = json.load(f)
    t = TransformerConfig.from_dict(raw["transformer"])
    b = GraniteBlockConfig.from_dict(raw["block"])
    b.check(t)
    assert raw["reduced"] == ["num_hidden_layers", "layer_types"]
    for key, value in raw["block"].items():
        if key not in raw["reduced"]:
            assert raw[key] == value, key
    assert raw["num_hidden_layers"] == 40 and len(raw["layer_types"]) == 40
    assert list(b.layer_types) == raw["layer_types"][:10]
    assert b.attention_layers == (5,)
    assert (t.hidden_dim, t.num_attn_heads, t.num_kv_heads) == (
        raw["hidden_size"], raw["num_attention_heads"],
        raw["num_key_value_heads"])
    assert t.num_layers == 10
    assert t.head_dim == raw["assumed"]["head_dim"] == 128
    assert b.mamba_inner == 8192 and b.conv_channels == 8448
    g = ref.Geometry.of(raw["transformer"], raw["block"])
    with torch.device("meta"):
        model = MakeAScene(t, block=b)
    n = sum(p.numel() for p in model.transformer.parameters())
    assert 7.9e9 < n < 8.0e9
    assert {k for k, *_ in ref.param_spec(g)} == set(model.state_dict())
