"""The Granite-4.0-H-Small cell at a size a CPU test run holds: the cell's
traffic and checks over a tiny Granite block (3 layers: Mamba2,
attention, Mamba2; width 128, Mamba2 heads 4 x 32 with a state of 16,
chunks of 8; 4 query heads over 2 kv heads; 8 experts of 32 with top-2
and a shared expert of 48), the chip check skipped.  The products'
weights are drawn ``WIDEN`` times wider than the cell's stds (the square
root of the fan-in's ratio, 4096 / 128), so that the activations have the
sizes they have at the published width, where the state and the shared
expert are a large part of each layer's output.  Sound runs come out
correct; with any of the seven planted faults, ``correct`` comes out
false.

The limits are set as the cell's are, from readings at this size on the
CPU over seeds 100-109 (``calibrate.readings``; the program's largest,
the smallest of the fp8 control and the faults), each about their
geometric mean: ``logit_err`` at most 0.0396, the control at least
0.256, the state frozen 0.313, the conv bias dropped 0.310, the shared
expert dropped 0.778, D, the gate or the residual multiplier dropped
1.06-1.21; ``route_gap`` at most 5.8e-5, the control at least 7.0e-4,
the runner-up set 0.083 (its ``logit_err`` 0.029 is sound: the reference
takes the program's experts); ``image_rel_err`` at most 0.0165, the
control at least 0.149; ``token_err`` 0, the altered token 42.1."""

import copy
from unittest import mock

import pytest

from perfbench import calibrate, run, spec
from perfbench.reference import granite_hybrid
from perfbench.tests import tiny
from perfbench.traffic import serve_granite

CELL = "granite_4h_small_256.b256"
SEEDS = (11, 2 ** 33 + 5)
WIDEN = 5.66
LIMITS = {"logit_err": 0.1, "route_gap": 2e-4, "image_rel_err": 0.05,
          "token_err": 2.0}
SPEC = granite_hybrid.param_spec


def _widened(g):
    return [(name, shape, mean, std * (WIDEN if (
        "_proj." in name or "experts." in name or "shared." in name)
        else 1.0), role) for name, shape, mean, std, role in SPEC(g)]


@pytest.fixture(autouse=True)
def _wide_weights():
    with mock.patch.object(granite_hybrid, "param_spec", _widened):
        yield


def tiny_cell(**over) -> spec.Cell:
    c = copy.deepcopy(spec.cell(CELL))
    c.config["transformer"] = dict(
        tiny.TRANSFORMER, num_layers=3, num_attn_heads=4, num_kv_heads=2,
        kv_cache_dtype=c.config["transformer"]["kv_cache_dtype"])
    del c.config["transformer"]["cogview_sandwich_layernorm"]
    c.config["block"] = dict(
        c.config["block"], layer_types=["mamba", "attention", "mamba"],
        intermediate_size=32, shared_intermediate_size=48,
        num_local_experts=8, num_experts_per_tok=2, mamba_n_heads=4,
        mamba_d_head=32, mamba_d_state=16, mamba_expand=1,
        mamba_chunk_size=8)
    c.config["model"] = dict(tiny.MODEL)
    c.traffic.update(over, batch=2, caption_tokens=[1, 6], prompt_batches=4)
    c.check["limits"] = dict(LIMITS)
    return c


def _run(seed, trace=False):
    return run.execute(CELL, seed, 0.0, trace, "cpu", tiny_cell())


@pytest.mark.parametrize("seed", SEEDS)
def test_sound_run_is_correct(seed):
    out = _run(seed)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_control_reads_above_the_limits():
    line = next(calibrate.readings(CELL, [SEEDS[0]], 1, 0.0, "cpu",
                                   tiny_cell()))
    for key in ("logit_err", "route_gap", "image_rel_err"):
        assert line["control"][key] > LIMITS[key], key


def test_fault_readings_read_above_the_limit():
    # calibrate's planted-fault readings: the program rebuilt with the
    # fault, teacher-forced on the judged prompts
    out = _run(SEEDS[1])
    for fault in serve_granite.FAULTS:
        got = out["faults"][fault]()
        assert any(got[k] > LIMITS[k] for k in got), (fault, got)


def test_traced_run_reads_its_layers():
    # on the CPU the slice holds no device time: the stamped, operation
    # and counter readers find their numbers, the device's readers none
    got = _run(3, trace=True)["layer_metrics"]
    assert set(got) == {"decode_step_ms.granite_b256",
                        "prefill_ms.granite_b256",
                        "vq_decode_ms.granite_b256",
                        "serve_mfu.granite_b256",
                        "expert_load.granite_b256"}
    assert all(v > 0 for v in got.values())
    assert got["expert_load.granite_b256"] >= 1.0
