"""BENCHMARK.json against the contract it is written to, and every file
it names found by name."""

import importlib
import json
import re

import pytest

from perfbench import layer_metrics, spec
from perfbench.reference import vqvae

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = ("hidden", "intermediate", "latent", "state", "projection", "head",
          "expansion", "experts_per_tok", "channels")
COMPARED = {"serve": ("logit_err", "image_rel_err", "token_err"),
            "train": ("loss_gap", "grad_gap", "change_gap")}


def test_keys_and_command():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_check_fits_with_24_cells():
    per_run = BENCH["run_seconds"] + 60
    assert (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_text():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    for group in (names, [w["name"] for w in BENCH["workloads"]],
                  [c["name"] for c in BENCH["configs"]]):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group), group
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"setup_s", "images_per_s", "train_tokens_per_s"}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_enough():
    names = {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        c = spec.cell(w["name"])
        e2e = [m["name"] for m in c.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c.per_layer
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", [])) <= names


def test_per_layer_moves_what_its_cells_report():
    for m in BENCH["per_layer"]:
        assert "workloads" in m
        for cell in m["workloads"]:
            moved = [e for e in spec.cell(cell).end_to_end
                     if e["name"] == m["moves"]]
            assert moved, (m["name"], cell)


def test_shares_named_and_bounded():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    rooflines = [m for m in BENCH["per_layer"] if "roofline" in m["name"]]
    assert all(m["name"].split(".", 1)[0].endswith("_roofline")
               for m in rooflines)
    mfu_moves = {m["moves"] for m in BENCH["per_layer"]
                 if "mfu" in m["name"]}
    assert {m["moves"] for m in rooflines} <= mfu_moves


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_found_by_name(metric):
    assert layer_metrics.read(metric, {}) is None   # nothing to read


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_resolve(cell):
    c = spec.cell(cell)
    driver = c.traffic["driver"]
    importlib.import_module(f"perfbench.traffic.{driver}")
    assert set(c.limits) == set(COMPARED[driver])
    assert all(isinstance(v, float) and v > 0 for v in c.limits.values())


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=lambda c: c["name"])
def test_configs(config):
    assert config["file"] == f"perfbench/configs/{config['name']}.json"
    with open(spec.ROOT / config["file"]) as f:
        body = json.load(f)
    assert body["source"] == config["source"]
    assert body["reduced"] == config["reduced"] == []
    assert len(config["reduced"]) <= 16
    for key in config["reduced"]:
        assert not any(w in key for w in WIDTHS) and not key.endswith(
            ("_dim", "_rank"))
    assert config["source"].startswith("https://")
    if "model" in body:
        assert vqvae.plan(body["model"])[-1].cout == \
            body["model"]["out_channels"]


def test_four_chip_cells_are_few():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
