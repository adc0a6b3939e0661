"""The decode step's body, which reads the position from a device tensor so
that a CUDA graph can replay it (``MakeAScene.decode_body``), against the
step as it was with a host position, on the CPU: logits and caches
bitwise at every step over lane, packed, float, MQA (bf16 scales) and
rudalle_relax float caches; every step runs eagerly and ``sample_tokens``
draws the same tokens; the graph's key follows the caches.  Each accepted
cache configuration gives its decode state kind
(``models/decode_state.py``), and a hybrid model's key follows its conv
states.

The slice is ``test_torch_port_decode_variants.py``'s (2 layers, 2 heads
of 64, text 48 + seg 4^2 + image 8^2 = 128 tokens).  One model and one
guided prefill per cache kind serve every test of this file.  Torch runs
one thread here: the tests run in several worker processes on a few
cores, where more threads a process slow these small operations down.
"""

import copy
from unittest import mock

import numpy as np
import pytest
import torch

from mas_tpu_torch.models import decode_state
from mas_tpu_torch.models.decode_graph import DecodeGraph, _key
from mas_tpu_torch.models.sampler import sample_tokens
from mas_tpu_torch.models.transformer import MakeAScene
from mas_tpu_torch.utils.config import HybridBlockConfig, TransformerConfig

SLICE = dict(num_layers=2, hidden_dim=128, num_attn_heads=2,
             image_vocab_size=96, seg_vocab_size=32, text_vocab_size=88,
             image_tokens_per_dim=8, seg_tokens_per_dim=4, text_length=48)
STEP_CACHES = {
    "lane-int4": dict(kv_cache_dtype="int4"),
    "lane-int8-bf16": dict(kv_cache_dtype="int8", compute_dtype="bfloat16"),
    "packed-int4": dict(kv_cache_dtype="int4", kv_cache_layout="packed"),
    "float": dict(kv_cache_dtype="compute"),
    "mqa-lane-int4-bf16-scales": dict(kv_cache_dtype="int4",
                                      num_kv_heads=1,
                                      kv_scale_dtype="bfloat16"),
    "rudalle-float": dict(kv_cache_dtype="compute", rudalle_relax=True,
                          cogview_layernorm_prescale=True)}
_BUILT = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tokens(cfg, b=2, seed=1):
    """``test_torch_port_models._tokens``: text with 3 pads, seg, image."""
    r = np.random.default_rng(seed)
    text = r.integers(1, cfg.text_vocab_size - cfg.text_length,
                      (b, cfg.text_length))
    text[:, -3:] = 0
    seg = r.integers(0, cfg.seg_vocab_size, (b, cfg.seg_length))
    img = r.integers(0, cfg.image_vocab_size, (b, cfg.image_length))
    return (torch.from_numpy(a) for a in (text, seg, img))


def _prefilled(cache):
    """(model, text, seg, img, the guided prefill's (logits, k/v)) of cache
    kind ``cache``, built once for the file."""
    if cache not in _BUILT:
        torch.manual_seed(51)
        model = MakeAScene(TransformerConfig(**SLICE, **STEP_CACHES[cache]))
        model.eval()
        text, seg, img = _tokens(model.cfg, seed=52)
        with torch.inference_mode():
            prefill = model.prefill(torch.cat([text, torch.zeros_like(text)]),
                                    torch.cat([seg, seg]))
        _BUILT[cache] = (model, text, seg, img, prefill)
    return _BUILT[cache]


def _int_step(model, img_token, step, caches):
    """The decode step as it was before its body read the position from a
    device tensor: positions from ``arange`` at a host offset, the cache
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


def _cache_tensors(caches) -> list:
    return [t for state in caches for t in state.tensors()]


@pytest.mark.parametrize("cache", list(STEP_CACHES))
def test_device_position_body_is_bitwise_the_int_step(cache):
    """``decode_body`` with one persistent step tensor set in place before
    each call, as a graph replay sees it, gives the int-step path's logits
    and caches bit for bit at every step."""
    model, _, _, img, (_, kvs) = _prefilled(cache)
    img2 = torch.cat([img, img])
    pos = torch.zeros(1, dtype=torch.int32)
    with torch.inference_mode():
        got_caches = model.allocate_caches(kvs, 4)
        want_caches = model.allocate_caches(kvs, 4)
        for step in range(model.cfg.image_length - 1):
            tok = img2[:, step:step + 1]
            pos.fill_(step)
            got = model.decode_body(tok, pos, got_caches)
            want = _int_step(model, tok, step, want_caches)
            assert torch.equal(got, want), f"step {step}"
            assert all(torch.equal(a, b) for a, b in zip(
                _cache_tensors(got_caches), _cache_tensors(want_caches))), \
                f"caches at step {step}"


@pytest.mark.parametrize("cache", list(STEP_CACHES))
def test_decode_step_on_cpu_is_eager_and_samples_as_before(cache):
    """On the CPU no step is captured or replayed, and ``sample_tokens``
    draws the tokens that the int-step path draws from the same seed."""
    model, text, seg, _, prefill = _prefilled(cache)
    with mock.patch.object(model, "prefill", lambda *a: prefill):
        before = (DecodeGraph.captures, DecodeGraph.replays,
                  DecodeGraph.eager)
        got = sample_tokens(model, text, seg,
                            torch.Generator().manual_seed(5),
                            guidance_scale=3.0, top_k=8)
        assert (DecodeGraph.captures, DecodeGraph.replays) == before[:2]
        assert DecodeGraph.eager == before[2] + model.cfg.image_length - 1
        with mock.patch.object(
                model, "decode_step", lambda tok, step, caches: _int_step(
                    model, tok, step, caches)):
            want = sample_tokens(model, text, seg,
                                 torch.Generator().manual_seed(5),
                                 guidance_scale=3.0, top_k=8)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cache", list(STEP_CACHES))
def test_decode_graph_key_follows_the_caches(cache):
    """The key a graph is held to: equal for the same caches and token
    shape, changed by new caches or another batch."""
    model, _, _, _, (_, kvs) = _prefilled(cache)
    tok = torch.zeros(4, 1, dtype=torch.long)
    with torch.inference_mode():
        a, b = model.allocate_caches(kvs, 4), model.allocate_caches(kvs, 4)
    assert _key(tok, a) == _key(tok, a)
    assert _key(tok, a) != _key(tok, b)
    assert _key(tok, a) != _key(tok[:2], a)
    copied = copy.deepcopy(model)
    assert isinstance(copied._decode_graph, DecodeGraph)
    assert copied._decode_graph is not model._decode_graph


# (kv_cache_dtype, kv_cache_layout, kv_scale_dtype, compute_dtype) -> the
# state kind and its buffers' dtypes
KINDS = {
    ("compute", "lane", "float32", "float32"):
        (decode_state.FloatState, [torch.float32] * 2),
    ("compute", "lane", "float32", "bfloat16"):
        (decode_state.FloatState, [torch.bfloat16] * 2),
    ("int8", "lane", "float32", "float32"):
        (decode_state.LaneState, [torch.int8, torch.float32] * 2),
    ("int4", "lane", "float32", "float32"):
        (decode_state.LaneState, [torch.uint8, torch.float32] * 2),
    ("int8", "lane", "bfloat16", "float32"):
        (decode_state.LaneState, [torch.int8, torch.bfloat16] * 2),
    ("int4", "lane", "bfloat16", "bfloat16"):
        (decode_state.LaneState, [torch.uint8, torch.bfloat16] * 2),
    ("int8", "lane_aliased", "float32", "float32"):
        (decode_state.LaneState, [torch.int8, torch.float32] * 2),
    ("int4", "lane_aliased", "float32", "float32"):
        (decode_state.LaneState, [torch.uint8, torch.float32] * 2),
    ("int8", "packed", "float32", "float32"):
        (decode_state.PackedState, [torch.int8, torch.float32]),
    ("int4", "packed", "float32", "float32"):
        (decode_state.PackedState, [torch.uint8, torch.float32])}


@pytest.mark.parametrize("knobs", list(KINDS), ids="-".join)
def test_cache_configuration_chooses_its_state(knobs):
    """``allocate_caches`` gives one state a layer, of the kind and buffer
    dtypes the configuration names (``lane_aliased`` is the lane kind),
    every buffer ``total_length`` positions long, the prefix seeded."""
    dtype, layout, scales, compute = knobs
    kind, dtypes = KINDS[knobs]
    torch.manual_seed(53)
    model = MakeAScene(TransformerConfig(
        **SLICE, kv_cache_dtype=dtype, kv_cache_layout=layout,
        kv_scale_dtype=scales, compute_dtype=compute)).eval()
    text, seg, _ = _tokens(model.cfg, seed=54)
    with torch.inference_mode():
        _, kvs = model.prefill(text, seg)
        caches = model.allocate_caches(kvs, text.shape[0])
    cfg = model.cfg
    assert len(caches) == cfg.num_layers
    for state in caches:
        assert type(state) is kind
        tensors = state.tensors()
        assert [t.dtype for t in tensors] == dtypes
        for t in tensors:
            assert t.shape[:3] == (2, 2, cfg.total_length) or \
                t.shape[1:] == (2, 2, cfg.total_length)     # packed scales
        assert tensors[0][:, :, :cfg.prefix_length].any()
        assert not tensors[0][:, :, cfg.prefix_length:].any()


@pytest.mark.parametrize("cache", ["int4", "compute"])
def test_hybrid_graph_key_follows_the_states(cache):
    """A hybrid model's key holds every conv state's buffer: unchanged
    across decode steps, changed when one conv state's buffer is
    replaced."""
    torch.manual_seed(55)
    cfg = TransformerConfig(
        num_layers=3, hidden_dim=64, num_attn_heads=4, num_kv_heads=2,
        image_vocab_size=96, seg_vocab_size=32, text_vocab_size=88,
        image_tokens_per_dim=8, seg_tokens_per_dim=4, text_length=16,
        kv_cache_dtype=cache)
    model = MakeAScene(cfg, block=HybridBlockConfig(
        layer_types=["conv", "full_attention", "conv"], intermediate_size=64,
        moe_intermediate_size=32, num_experts=4, num_experts_per_tok=2,
        num_dense_layers=1)).eval()
    text, seg, img = _tokens(cfg, seed=56)
    pos = torch.zeros(1, dtype=torch.int32)
    with torch.inference_mode():
        _, seeds = model.prefill(text, seg)
        caches = model.allocate_caches(seeds, text.shape[0])
        key = _key(img[:, :1], caches)
        for step in range(3):
            pos.fill_(step)
            model.decode_body(img[:, step:step + 1], pos, caches)
            assert _key(img[:, step + 1:step + 2], caches) == key
    assert [type(s).__name__ for s in caches][::2] == ["ConvState"] * 2
    caches[2].data = caches[2].data.clone()
    assert _key(img[:, :1], caches) != key
