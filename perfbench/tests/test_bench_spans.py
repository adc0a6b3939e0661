"""The span slice's arithmetic on hand-made timelines and on the program's
own spans on the CPU, its readers (``host.py``, ``ops.py``, ``wait.py``),
and traced runs of the tiny cells, which leave the spans off."""

import pytest
import torch

from perfbench import layer_metrics, run, span_slice, trace
from perfbench.span_slice import DEVICE, OP, SPAN, UNTRACED
from perfbench.tests import tiny


class _Kineto:
    """A kineto event as ``classify`` reads it."""

    def __init__(self, name, kind, start_us, end_us, thread=1):
        self.n, self.kind, self.thread = name, kind, thread
        self.s, self.d = int(start_us * 1e3), int((end_us - start_us) * 1e3)

    def name(self):
        return self.n

    def activity_type(self):
        return self.kind

    def device_type(self):
        on_host = self.kind in ("cpu_op", "user_annotation", "cuda_runtime",
                                "overhead")
        return (torch.autograd.DeviceType.CPU if on_host
                else torch.autograd.DeviceType.CUDA)

    def is_user_annotation(self):
        return self.kind in ("user_annotation", "gpu_user_annotation")

    def start_thread_id(self):
        return self.thread

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d


def test_annotations_on_the_device_are_not_busy():
    events = span_slice.classify([
        _Kineto("mas.decode_step", "user_annotation", 0, 100),
        _Kineto("mas.decode_step", "gpu_user_annotation", 10, 90),
        _Kineto("other_range", "gpu_user_annotation", 0, 100),
        _Kineto("cudaLaunchKernel", "cuda_runtime", 5, 6),
        _Kineto("aten::mm", "cpu_op", 2, 8),
        _Kineto("gemm", "kernel", 20, 30),
        _Kineto("Memcpy DtoH", "gpu_memcpy", 40, 45)])
    assert sorted(k for k, *_ in events) == [DEVICE, DEVICE, OP, SPAN]
    assert ("span", "decode_step", 1, 0.0, 100.0) in events
    s = span_slice.summarize(events)
    assert s.busy_s == pytest.approx(15e-6)
    assert s.idle_s == pytest.approx(85e-6)


class _OlderKineto(_Kineto):
    """An event of a torch that reports no activity kind (2.11)."""

    activity_type = None


def test_kinds_from_names_without_activity_types():
    events = span_slice.classify([
        _OlderKineto("mas.adam", "user_annotation", 0, 100),
        _OlderKineto("mas.adam", "gpu_user_annotation", 10, 90),
        _OlderKineto("cudaLaunchKernel", "cuda_runtime", 5, 6),
        _OlderKineto("cuLaunchKernel", "cuda_runtime", 6, 7),
        _OlderKineto("Command Buffer Full", "overhead", 9, 12),
        _OlderKineto("Buffer Flush", "overhead", 1, 3),
        _OlderKineto("aten::mul", "cpu_op", 2, 8),
        _OlderKineto("autograd::engine::evaluate_function: MulBackward0",
                     "cpu_op", 8, 9),
        _OlderKineto("vectorized_elementwise_kernel", "kernel", 20, 30)])
    assert sorted((k, n) for k, n, *_ in events) == [
        (DEVICE, "vectorized_elementwise_kernel"), (OP, "aten::mul"),
        (OP, "autograd::engine::evaluate_function: MulBackward0"),
        (SPAN, "adam")]


# host clock in us: two units (a batch: a root span each) of a step span
# holding an inner span; device work between
TIMELINE = [
    (SPAN, "root", 1, 0.0, 100.0),
    (SPAN, "step", 1, 10.0, 50.0),
    (SPAN, "head", 1, 30.0, 40.0),
    (SPAN, "root", 1, 110.0, 200.0),
    (SPAN, "step", 1, 120.0, 160.0),
    (SPAN, "head", 1, 140.0, 150.0),
    (DEVICE, "k", 0, 5.0, 20.0),       # idle 0-5 in root
    (DEVICE, "k", 0, 24.0, 32.0),      # idle 20-24 in step
    (DEVICE, "k", 0, 38.0, 60.0),      # idle 32-38 mid 35 in head
    (DEVICE, "k", 0, 55.0, 104.0),     # overlaps; idle 104-112 mid 108 none
    (DEVICE, "k", 0, 112.0, 141.0),    # idle 141-149 mid 145 in head
    (DEVICE, "k", 0, 149.0, 180.0),    # idle 180-205 mid 192.5 in root
    (OP, "aten::linear", 1, 12.0, 18.0),
    (OP, "aten::mm", 1, 13.0, 17.0),          # inside linear: not counted
    (OP, "aten::view", 1, 18.0, 18.25),       # at linear's end: held too
    (OP, "aten::topk", 1, 31.0, 33.0),
    (OP, "aten::sum", 1, 102.0, 104.0),       # outside every span
    (OP, "autograd::engine::evaluate_function: MmBackward0", 2, 121.0,
     125.0),                                  # another thread, in step
    (OP, "MmBackward0", 2, 121.5, 124.0),
    (OP, "aten::add", 1, 205.0, 205.0),       # the stretch's last event
]


def test_idle_goes_to_the_innermost_span():
    s = span_slice.summarize(TIMELINE)
    assert s.count == {"root": 2, "step": 2, "head": 2}
    assert s.busy_s == pytest.approx((15 + 8 + 66 + 29 + 31) * 1e-6)
    assert s.idle == pytest.approx({"root": 30e-6, "step": 4e-6,
                                    "head": 14e-6, UNTRACED: 8e-6})
    assert s.idle_s == pytest.approx(56e-6)


def test_ops_count_outermost_calls():
    s = span_slice.summarize(TIMELINE)
    assert s.ops == {"step": 2, "head": 1, UNTRACED: 2}


def test_waits_times_counts_sum_to_the_windows_idle():
    ss = span_slice.summarize(TIMELINE)
    # the traced slice: 2 units, 120 us busy; the window took 150 us a unit
    sl = trace.Slice(window_s=1.0, busy_s=120e-6)
    obs = {"span_slice": ss, "slice": sl, "slice_units": 2, "unit_s": 150e-6}
    idle_ms = 1e3 * (150e-6 - 60e-6)
    total = layer_metrics.read("untraced_wait.c", obs)
    for span in ("root", "step", "head"):
        wait = layer_metrics.read(f"{span}_wait.c", obs)
        assert wait == pytest.approx(idle_ms * ss.idle[span] / ss.idle_s
                                     / (ss.count[span] / 2))
        total += wait * ss.count[span] / 2
    assert total == pytest.approx(idle_ms)
    assert layer_metrics.read("untraced_wait.c", obs) == pytest.approx(
        idle_ms * 8 / 56)
    assert layer_metrics.read("step_ops.c", obs) == 1.0
    assert layer_metrics.read("absent_wait.c", obs) is None
    assert layer_metrics.read("absent_ops.c", obs) is None


def test_readers_find_nothing_to_read():
    for name in ("decode_step_host.x", "decode_step_ops.x",
                 "decode_step_wait.x", "untraced_wait.x"):
        assert layer_metrics.read(name, {}) is None
        assert layer_metrics.read(name, {"spans": [], "span_slice": None,
                                         "slice": None}) is None
    # a CPU run: the traced slice holds no device time
    obs = {"span_slice": span_slice.summarize(TIMELINE), "slice_units": 2,
           "slice": trace.Slice(window_s=1.0, busy_s=0.0), "unit_s": 1e-4}
    assert layer_metrics.read("step_wait.x", obs) is None
    assert layer_metrics.read("untraced_wait.x", obs) is None


def test_host_reads_the_windows_records():
    from mas_tpu_torch.utils.spans import Record

    recs = [Record("adam", 2, 1, 1, 0, 3_000_000),
            Record("adam", 4, 3, 3, 10, 5_000_010),
            Record("train_step", 1, None, 1, 0, 9_000_000)]
    assert layer_metrics.read("adam_host.train", {"spans": recs}) == 4.0
    assert layer_metrics.read("backward_host.train", {"spans": recs}) is None


def test_span_slice_reads_program_spans():
    # one unit: a step span holding an Adam span, as the program nests them
    from mas_tpu_torch.utils import spans

    x = torch.ones(8)

    def step():
        with spans.span("train_step"):
            with spans.span("adam"):
                x.mul(2).add(1)
            x.sum()

    ss = span_slice.record(lambda: [step() for _ in range(2)],
                           torch.device("cpu"))
    assert ss.count == {"train_step": 2, "adam": 2}
    assert ss.ops["adam"] == 4 and ss.ops["train_step"] == 2
    obs = {"span_slice": ss, "slice_units": 2, "unit_s": 1e-3,
           "slice": trace.Slice(window_s=1.0, busy_s=0.0)}
    assert layer_metrics.read("adam_ops.x", obs) == 2.0
    # no device time on the CPU: the waits find nothing
    assert layer_metrics.read("adam_wait.x", obs) is None
    # the slice turns spans off again and keeps none of its records
    with spans.span("after"):
        pass
    assert spans.drain() == []


OLD = {"sample_256.b384": {"decode_step_ms.b384", "prefill_ms.b384",
                           "vq_decode_ms.b384", "serve_mfu.b384"},
       "transformer_512.train_b8": {"adam_ms.train", "train_mfu"}}


@pytest.mark.parametrize("name", sorted(OLD))
def test_traced_run_leaves_spans_off(name):
    # the drivers record no span slice: a traced run reads what it read
    # before the program had spans, and the span readers find nothing
    from mas_tpu_torch.utils import spans

    out = run.execute(name, 2 ** 33 + 7, 0.0, True, "cpu", tiny.cell(name))
    assert set(out["layer_metrics"]) == OLD[name]
    for family in ("host", "ops", "wait"):
        assert layer_metrics.read(f"decode_step_{family}.x",
                                  out["obs"]) is None
    with spans.span("after"):
        pass
    assert spans.drain() == []
    assert out["correct"], out["compared"]
