"""The LFM2-8B-A1B cell at a size a CPU test run holds: the cell's traffic
and checks over a tiny hybrid model (4 layers: conv, conv, attention,
conv; the first 2 dense; 8 experts with top-4, so that the weights'
normalization matters at this width, where two sigmoid scores near 0.5
sum to about 1; 4 query heads over 2 kv heads), the chip check skipped.
Sound runs come out correct; with the
router's expert bias dropped (in every MoE layer, or in one), its weights
left unnormalized, the runner-up expert set taken, or the conv state not
advanced, ``correct`` comes out false.

The limits are set as the cell's are, from readings at this size on the
CPU over seeds 100-109 (``calibrate.readings``; the program's largest, the
smallest of the fp8 control and the faults): ``logit_err`` at most 0.0926,
the control at least 0.203, unnormalized 0.158, frozen conv state 0.175;
``route_gap`` (the largest MoE layer's mean deficit) at most 4.7e-5, the
control at least 1.9e-4, bias dropped 0.0046, bias dropped in one layer
0.0030, runner-up set 0.016; ``image_rel_err`` at most 0.0182, the
control at least 0.142; ``token_err`` 0 (a sound sampling head reads at
most 1 by construction)."""

import copy

import pytest

from perfbench import calibrate, run, spec
from perfbench.tests import tiny
from perfbench.traffic import serve_lfm2

CELL = "lfm2_8b_a1b_256.b384"
SEEDS = (11, 2 ** 33 + 5)
LIMITS = {"logit_err": 0.13, "route_gap": 7e-5, "image_rel_err": 0.06,
          "token_err": 2.0}


def tiny_cell(**over) -> spec.Cell:
    c = copy.deepcopy(spec.cell(CELL))
    c.config["transformer"] = dict(
        tiny.TRANSFORMER, num_layers=4, num_attn_heads=4, num_kv_heads=2,
        kv_cache_dtype=c.config["transformer"]["kv_cache_dtype"])
    del c.config["transformer"]["cogview_sandwich_layernorm"]
    c.config["block"] = dict(
        c.config["block"], layer_types=["conv", "conv", "full_attention",
                                        "conv"],
        intermediate_size=256, moe_intermediate_size=64, num_experts=8,
        num_experts_per_tok=4)
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


@pytest.mark.parametrize("fault", list(serve_lfm2.FAULTS))
def test_faults_fail(fault):
    with serve_lfm2.FAULTS[fault]():
        out = _run(SEEDS[0])
    assert not out["correct"], out["compared"]


def test_fault_readings_read_above_the_limit():
    # calibrate's planted-fault readings: the program rebuilt with the
    # fault, teacher-forced on the judged prompts
    out = _run(SEEDS[1])
    for fault in serve_lfm2.FAULTS:
        got = out["faults"][fault]()
        assert any(got[k] > LIMITS[k] for k in got), (fault, got)


def test_traced_run_reads_its_layers():
    # on the CPU the slice holds no device time: the stamped, operation
    # and counter readers find their numbers, the device's readers none
    got = _run(3, trace=True)["layer_metrics"]
    assert set(got) == {"decode_step_ms.lfm2_b384", "prefill_ms.lfm2_b384",
                        "serve_mfu.lfm2_b384", "expert_load.lfm2_b384"}
    assert all(v > 0 for v in got.values())
    assert got["expert_load.lfm2_b384"] >= 1.0
