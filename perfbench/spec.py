"""What one cell of the benchmark is, read from ``BENCHMARK.json`` and the
files it names by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each is a file of its own under this folder:

* ``configs/<config>.json``: the configuration as it is run (the port's
  config sections, its source, ``reduced`` and ``assumed``);
* ``traffic/<traffic>.json``: the traffic mix, whose ``driver`` names the
  general generator in ``traffic/<driver>.py`` that reads it;
* ``workloads/<cell>.json``: the cell's correctness check: how much of
  the window it compares and the limit of each number compared.

A metric is reported in a cell when it has no ``workloads`` list or lists
the cell.  A per-layer metric is read by a module of ``layer_metrics/``
found by its name (``layer_metrics/__init__.py``).

This module needs neither torch nor the program.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _load(root / "BENCHMARK.json")


def reported_in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def limits(self) -> Dict[str, Optional[float]]:
        return self.check.get("limits", {})


def cell(name: str, bench: Optional[dict] = None,
         pkg: Path = PKG) -> Cell:
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in bench['workloads']]}")
    return Cell(
        name=name, chips=entry["chips"],
        config=_load(pkg / "configs" / f"{entry['config']}.json"),
        traffic=_load(pkg / "traffic" / f"{entry['traffic']}.json"),
        check=_load(pkg / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reported_in(m, name)],
        per_layer=[m for m in bench["per_layer"] if reported_in(m, name)])
