"""The traced slice's arithmetic on hand-made timelines, and the kernel
ids."""

import pytest

from perfbench import kernels, trace
from perfbench import layer_metrics


def test_kernel_ids():
    ids = {"flash_fwd_kernel_bf16<64>": "B1",
           "void decode_quant_kernel<__nv_bfloat16, 64>": "B2",
           "kv_write_lane_kernel": "B3", "kv_write_packed_kernel": "B10",
           "flash_bwd_dq_kernel_bf16": "B6", "flash_bwd_delta_kernel": "B6",
           "gn_swish_fwd_kernel": "B4", "vq_argmin_mma_kernel": "B5",
           "sm90_xmma_gemm_bf16bf16": None}
    for name, kid in ids.items():
        assert kernels.kernel_id(name) == kid


def test_union_counts_overlap_once():
    assert trace.union([(0, 2), (1, 3), (5, 6), (6, 7)]) == [(0, 3), (5, 7)]


EVENTS = [
    ("aten::linear", False, 0.0, 10.0),
    ("aten::mm", False, 1.0, 9.0),          # inside linear
    ("aten::topk", False, 20.0, 40.0),
    ("sm90_gemm", True, 5.0, 15.0),
    ("flash_fwd_kernel_bf16", True, 12.0, 18.0),   # overlaps the gemm
    ("decode_quant_kernel", True, 45.0, 47.0),
    ("decode_quant_kernel", True, 50.0, 53.0),
]


def test_summarize():
    s = trace.summarize(EVENTS, window_s=60e-6)
    assert s.busy_s == pytest.approx((18 - 5 + 2 + 3) * 1e-6)
    assert s.kernel_s["B1"] == pytest.approx(6e-6)
    assert s.kernel_s["B2"] == pytest.approx(5e-6)
    assert s.device_ops[0] == ["sm90_gemm", pytest.approx(10e-6)]
    gaps = dict((k, v) for k, v in s.idle_gaps)
    # 0-5 in linear, 18-45 mid 31.5 in topk, 47-50 mid 48.5 between ops
    assert gaps["aten::linear"] == pytest.approx(5e-6)
    assert gaps["aten::topk"] == pytest.approx(27e-6)
    assert gaps[trace.BETWEEN] == pytest.approx(3e-6)


def test_readers_of_the_slice():
    s = trace.summarize(EVENTS, window_s=60e-6)
    # the slice holds one batch; the window took 40 us a batch
    obs = {"slice": s, "slice_units": 1, "unit_s": 40e-6,
           "bounds": {"B2": [1e-6, 2e-6]}}
    assert layer_metrics.read("idle.x", obs) == pytest.approx(
        100 * (1 - 18 / 40))
    assert layer_metrics.read("b2_roofline.x", obs) == pytest.approx(
        100 * 3 / 5)
    assert layer_metrics.read("b6_roofline.x", obs) is None
    obs.update(slice_units=2)
    assert layer_metrics.read("attention_ms.x", obs) == pytest.approx(
        6e-3 / 2)


def test_readers_found_by_name():
    obs = {"layers": {"prefill_ms": [1.0, 3.0], "adam_ms": [5.0]},
           "flops": 989e12 * 0.5, "timed_s": 1.0}
    assert layer_metrics.read("prefill_ms.b64", obs) == 2.0
    assert layer_metrics.read("adam_ms.train", obs) == 5.0
    assert layer_metrics.read("vq_decode_ms.b64", obs) is None
    assert layer_metrics.read("serve_mfu.b64", obs) == pytest.approx(50.0)
    assert layer_metrics.reader("b9_roofline.c").__name__.endswith(
        ".roofline")
