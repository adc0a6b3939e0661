"""The decode step's body, which reads the position from a device tensor so
that a CUDA graph can replay it (``MakeAScene.decode_body``), against the
step as it was with a host position, on the CPU: logits and caches
bitwise at every step over lane, packed, float, MQA (bf16 scales) and
rudalle_relax float caches; every step runs eagerly and ``sample_tokens``
draws the same tokens; the graph's key follows the caches.

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

from mas_tpu_torch.models.decode_graph import DecodeGraph, _key
from mas_tpu_torch.models.sampler import sample_tokens
from mas_tpu_torch.models.transformer import MakeAScene
from mas_tpu_torch.ops import decode_cache, quant
from mas_tpu_torch.utils.config import TransformerConfig

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
    for layer, (k_cache, v_cache) in zip(model.transformer.layers, caches):
        x = layer.decode(x, k_cache, v_cache, index)
    return model._logits(model._final_ln(x))[:, 0]


def _cache_tensors(caches) -> list:
    out = []
    for pair in caches:
        for c in pair:
            if isinstance(c, quant.QuantCache):
                out += [c.q, c.scale]
            elif isinstance(c, decode_cache.PackedQuantCache):
                out += [c.kv, c.scale]
            elif c is not None:
                out.append(c.data)
    return out


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
