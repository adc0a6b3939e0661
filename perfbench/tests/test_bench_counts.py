"""The yardstick's arithmetic against hand counts and PERF.md's kernel
table (PR 16's bounds)."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import counts, weights
from perfbench.reference import transformer as ref_t
from perfbench.reference import vqvae as ref_v
from perfbench.tests import tiny


def test_peaks():
    assert counts.BF16_FLOPS == 989e12
    assert counts.FP32_FLOPS == 67e12
    assert counts.HBM_BYTES_S == 3.35e12


def test_bounds_of_the_kernel_table():
    # PERF.md section 6: B2 128 rows, T 640, index 511; B1/B6 [8,16,1408,64]
    assert counts.b2_bound_s(128, 16, 64, 511) * 1e3 == pytest.approx(
        0.0227, abs=5e-5)
    assert counts.b2_bound_s(8, 16, 64, 511) * 1e3 == pytest.approx(
        0.0014, abs=5e-5)
    assert counts.b1_bound_s(8, 16, 1408, 64, 384) * 1e3 == pytest.approx(
        0.0353, abs=5e-5)
    assert counts.b6_bound_s(8, 16, 1408, 64, 384) * 1e3 == pytest.approx(
        0.0883, abs=5e-5)


def test_b2_bound_by_hand():
    # 128 x 16 rows; 512 positions of int4 k and v (32 bytes each) and
    # their fp32 scales; q and out bf16
    nbytes = 128 * 16 * (512 * (32 + 32 + 4 + 4) + 64 * 2 * 2)
    assert counts.b2_bound_s(128, 16, 64, 511) == nbytes / 3.35e12
    # the bound grows with the cache index (384 + step)
    assert counts.b2_bound_s(128, 16, 64, 638) > counts.b2_bound_s(
        128, 16, 64, 384)


@pytest.mark.parametrize("t,prefix", [(1408, 384), (640, 384), (384, 384),
                                      (5, 2)])
def test_attended_pairs_by_loop(t, prefix):
    pairs = sum(prefix if i < prefix else i + 1 for i in range(t))
    assert counts.attended_pairs(t, prefix) == pairs
    if (t, prefix) == (1408, 384):
        assert pairs == 1_065_472


def _geometry():
    return ref_t.Geometry.of(tiny.TRANSFORMER)


def test_forward_flops_by_hand():
    g = _geometry()
    d, t = g.hidden, g.prefix + g.image_length
    per_token = 2 * g.layers * (3 * d * d + d * d + 8 * d * d)
    attn = 4 * g.layers * d * counts.attended_pairs(t, g.prefix)
    head = 2 * g.image_length * d * g.image_vocab
    assert counts.forward_flops(g, 3, t, g.image_length) == 3 * (
        per_token * t + attn + head)
    assert counts.train_step_flops(g, 3) == 3 * counts.forward_flops(
        g, 3, t, g.image_length)


def test_decode_flops_by_step():
    g = _geometry()
    rows, steps = 4, g.image_length - 1
    d = g.hidden
    total = sum(2 * rows * (g.layers * 12 * d * d + d * g.image_vocab)
                + 4 * rows * g.layers * d * (g.prefix + s + 1)
                for s in range(steps))
    assert counts.decode_flops(g, rows, steps) == total


def test_linear_flops_against_the_counter():
    # the reference's linears and head, counted by torch: its attention is
    # a full masked product, which counts.py counts over attended pairs
    g = _geometry()
    p = weights.make(ref_t.param_spec(g), 0, "cpu",
                     {"dense": torch.float32, "norm": torch.float32})
    t = g.prefix + g.image_length
    text = torch.randint(1, 10, (1, g.text_length))
    seg = torch.randint(0, g.seg_vocab, (1, g.seg_side ** 2))
    img = torch.randint(0, g.image_vocab, (1, g.image_length))
    with FlopCounterMode(display=False) as fc:
        h = ref_t.hidden(p, g, text, seg, img)
        ref_t.logits(p, g, h[:, -g.image_length - 1:-1])
    full_attn = 4 * g.layers * g.hidden * t * t
    attended = 4 * g.layers * g.hidden * counts.attended_pairs(t, g.prefix)
    assert fc.get_total_flops() - full_attn + attended == \
        counts.forward_flops(g, 1, t, g.image_length)


def test_vq_decode_flops_against_the_counter():
    m = tiny.MODEL
    p = weights.make(ref_v.param_spec(m), 0, "cpu",
                     {"conv": torch.float32, "fp32": torch.float32})
    side = m["resolution"] // 2 ** (len(m["channels"]) - 2)
    idx = torch.randint(0, 64, (2, side, side))
    with FlopCounterMode(display=False) as fc:
        ref_v.decode_code(p, m, idx)
    assert fc.get_total_flops() == counts.vq_decode_flops(m, 2)


def test_serve_batch_flops_parts():
    g, m = _geometry(), tiny.MODEL
    assert counts.serve_batch_flops(g, m, 2) == (
        counts.forward_flops(g, 4, g.prefix, 1)
        + counts.decode_flops(g, 4, g.image_length - 1)
        + counts.vq_decode_flops(m, 2))
