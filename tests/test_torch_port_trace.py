"""The port's program spans (``mas_tpu_torch/utils/spans.py``) at the
layer boundaries of serving and training, on the CPU: the spans a sampled
batch and a train step record and how they nest; the same bits with spans
on and off; off, no clock read and no profiler call; on, ``mas.*`` user
annotations only while a profiler runs; the buffer's cap.  Also the
device-busy union of ``breakdown.py`` on a hand-made event list."""

import numpy as np
import pytest
import torch

from mas_tpu_torch import breakdown
from mas_tpu_torch.models.sampler import sample_images, sample_tokens
from mas_tpu_torch.models.transformer import MakeAScene
from mas_tpu_torch.models.vqvae import VQModel
from mas_tpu_torch.train.state import create_transformer_train_state
from mas_tpu_torch.train.steps import make_transformer_train_step
from mas_tpu_torch.utils import spans
from mas_tpu_torch.utils.config import (OptimizerConfig, TransformerConfig,
                                        VQModelConfig)

T_TINY = dict(num_layers=2, hidden_dim=64, num_attn_heads=2,
              image_vocab_size=64, seg_vocab_size=32, text_vocab_size=72,
              image_tokens_per_dim=4, seg_tokens_per_dim=4, text_length=8,
              kv_cache_dtype="int4")
VQ_TINY = dict(channels=(32, 32, 64), resolution=8, attn_resolutions=(4,),
               z_channels=32, embed_dim=16, num_res_blocks=1,
               codebook=dict(codebook_size=64, codebook_dim=16,
                             reservoir_size=64))
B, CHUNK = 3, 2


@pytest.fixture(autouse=True)
def fresh_spans():
    spans.enable(False)
    spans.drain()
    yield
    spans.enable(False)
    spans.drain()


def _serving():
    torch.manual_seed(0)
    t = MakeAScene(TransformerConfig(**T_TINY)).eval()
    vq = VQModel(VQModelConfig(**VQ_TINY)).eval()
    r = np.random.default_rng(1)
    cfg = t.cfg
    text = torch.from_numpy(r.integers(1, 60, (B, cfg.text_length)))
    seg = torch.from_numpy(r.integers(0, cfg.seg_vocab_size,
                                      (B, cfg.seg_length)))
    return t, vq, text, seg


def _sample(t, vq, text, seg):
    gen = torch.Generator().manual_seed(5)
    return sample_images(t, vq, text, seg, gen, guidance_scale=3.0,
                         top_k=8, decode_chunk=CHUNK)


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_sample_images_records_its_layers_under_one_root():
    t, vq, text, seg = _serving()
    spans.enable(True)
    _sample(t, vq, text, seg)
    recs = spans.drain()
    by = _by_name(recs)
    n = t.cfg.image_length
    assert {k: len(v) for k, v in by.items()} == {
        "sample": 1, "prefill": 1, "cache_seed": 1, "decode_step": n - 1,
        "sample_head": n, "vq_decode": -(-B // CHUNK)}
    root = by["sample"][0]
    assert root.parent is None and root.root == root.id
    for r in recs:
        assert r.root == root.id
        assert root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
        if r is not root:
            assert r.parent == root.id
    assert len({r.id for r in recs}) == len(recs)
    # in the order the model ran them
    order = [r.name for r in sorted(recs, key=lambda r: r.start_ns)]
    assert order[:5] == ["sample", "prefill", "cache_seed", "sample_head",
                         "decode_step"]
    assert order[-CHUNK:] == ["vq_decode"] * CHUNK


def _train_state():
    cfg = TransformerConfig(**dict(T_TINY, kv_cache_dtype="compute"))
    state = create_transformer_train_state(
        cfg, OptimizerConfig(lr=1e-3, beta1=0.9, beta2=0.95),
        torch.Generator().manual_seed(0), "cpu")
    r = np.random.default_rng(2)
    batch = [torch.from_numpy(r.integers(1, 60, (2, cfg.text_length))),
             torch.from_numpy(r.integers(0, cfg.seg_vocab_size,
                                         (2, cfg.seg_length))),
             torch.from_numpy(r.integers(0, cfg.image_vocab_size,
                                         (2, cfg.image_length)))]
    step = make_transformer_train_step(state.model, state.opt, uncond_p=0.5)
    return state, step, batch


def test_train_step_holds_forward_backward_adam():
    state, step, batch = _train_state()
    spans.enable(True)
    for _ in range(2):
        step(state, *batch, torch.Generator().manual_seed(3))
    recs = spans.drain()
    roots = [r for r in recs if r.name == "train_step"]
    assert len(roots) == 2 and roots[0].root != roots[1].root
    for root in roots:
        kids = sorted((r for r in recs if r.parent == root.id),
                      key=lambda r: r.start_ns)
        assert [r.name for r in kids] == ["forward", "backward", "adam"]
        assert all(r.root == root.id and root.start_ns <= r.start_ns
                   and r.end_ns <= root.end_ns for r in kids)
    assert len(recs) == 8


def test_same_bits_with_spans_on_and_off():
    t, vq, text, seg = _serving()
    images, tokens = [], []
    for on in (False, True):
        spans.enable(on)
        images.append(_sample(t, vq, text, seg))
        tokens.append(sample_tokens(t, text, seg,
                                    torch.Generator().manual_seed(7),
                                    top_k=4))
    assert torch.equal(images[0], images[1])
    assert torch.equal(tokens[0], tokens[1])
    losses, params = [], []
    for on in (False, True):
        spans.enable(on)
        state, step, batch = _train_state()
        gen = torch.Generator().manual_seed(3)
        losses.append([step(state, *batch, gen)["loss"] for _ in range(2)])
        params.append({k: p.detach().clone()
                       for k, p in state.model.named_parameters()})
    assert all(torch.equal(a, b) for a, b in zip(*losses))
    assert all(torch.equal(params[0][k], params[1][k]) for k in params[0])


def _refuse(*args, **kwargs):
    raise AssertionError("entered with spans off or no profiler running")


def test_off_is_one_check(monkeypatch):
    monkeypatch.setattr(spans, "record_function", _refuse)
    monkeypatch.setattr(spans.time, "perf_counter_ns", _refuse)
    assert spans.span("a") is spans.span("b")      # the shared no-op
    t, vq, text, seg = _serving()
    _sample(t, vq, text, seg)
    state, step, batch = _train_state()
    step(state, *batch, torch.Generator().manual_seed(3))
    assert spans.drain() == [] and spans.dropped() == 0


def test_on_without_a_profiler_opens_no_range(monkeypatch):
    monkeypatch.setattr(spans, "record_function", _refuse)
    spans.enable(True)
    with spans.span("outer"):
        with spans.span("inner"):
            torch.ones(3).sum()
    inner, outer = spans.drain()
    assert (inner.name, inner.parent, inner.root) == ("inner", outer.id,
                                                      outer.id)
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_under_the_profiler_spans_are_annotations_around_their_ops():
    t, vq, text, seg = _serving()
    spans.enable(True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _sample(t, vq, text, seg)
    recs = _by_name(spans.drain())
    events = list(prof.profiler.kineto_results.events())
    notes = [e for e in events if e.name().startswith("mas.")]
    assert all(e.is_user_annotation() for e in notes)
    assert {n: sum(e.name() == "mas." + n for e in notes)
            for n in recs} == {n: len(v) for n, v in recs.items()}
    ops = [e for e in events if e.activity_type() == "cpu_op"]
    for note in notes:
        s, e = note.start_ns(), note.start_ns() + note.duration_ns()
        inside = [o for o in ops if s <= o.start_ns() <= e
                  and o.start_thread_id() == note.start_thread_id()]
        assert inside, note.name()
        assert all(o.start_ns() + o.duration_ns() <= e for o in inside)


def test_buffer_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(spans, "CAP", 3)
    spans.enable(True)
    for i in range(5):
        with spans.span(f"s{i}"):
            pass
    assert spans.dropped() == 2
    assert [r.name for r in spans.drain()] == ["s0", "s1", "s2"]
    assert spans.dropped() == 0 and spans.drain() == []


class _Event:
    def __init__(self, start_us, end_us, device=True, kind="kernel"):
        self.s, self.d = int(start_us * 1e3), int((end_us - start_us) * 1e3)
        self.device, self.kind = device, kind

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self.device
                else torch.autograd.DeviceType.CPU)

    def activity_type(self):
        return self.kind

    def is_user_annotation(self):
        return self.kind.endswith("user_annotation")

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d


class _OlderEvent(_Event):
    """An event of a torch that reports no activity kind (2.11)."""

    def __init__(self, name, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.n = name

    def name(self):
        return self.n

    activity_type = None


def test_breakdown_busy_is_the_union_of_device_intervals():
    events = [_Event(0, 10), _Event(5, 15),                # overlap: 0-15
              _Event(20, 22, kind="gpu_memcpy"),
              _Event(14, 40, kind="gpu_user_annotation"),  # a span: no work
              _Event(30, 90, device=False, kind="cpu_op"),
              _Event(50, 51), _Event(50.5, 50.75)]
    assert breakdown.device_busy_us(events) == pytest.approx(15 + 2 + 1)
    assert breakdown.device_busy_us([]) == 0.0
    older = [_OlderEvent("gemm", 0, 10), _OlderEvent("gemm", 5, 15),
             _OlderEvent("mas.decode_step", 14, 40),       # a span's range
             _OlderEvent("aten::mm", 30, 90, device=False)]
    assert breakdown.device_busy_us(older) == pytest.approx(15)
