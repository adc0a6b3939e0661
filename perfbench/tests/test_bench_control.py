"""The control (the reference in fp8 in the program's place) and the
planted faults come out as not correct under the cells' limits: at a tiny
size on the CPU, and at the cells' own size on the chip."""

import pytest

from perfbench import calibrate, spec
from perfbench.tests import tiny

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _judged(cell, readings):
    return all(v <= cell.limits[k] for k, v in readings.items())


def _failed(line):
    """The control's and every planted fault's readings."""
    return {k: v for k, v in line.items() if k not in ("seed", "program")}


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_a_tiny_size(name):
    cell = tiny.cell(name)
    for line in calibrate.readings(name, [5, 2 ** 35 + 1], 2, 0.0, "cpu",
                                   cell):
        assert "control" in line
        for readings in _failed(line).values():
            assert not _judged(cell, readings), line


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(cuda, name):
    cell = spec.cell(name)
    seeds = [2 ** 31 + 11, 4242, 77]
    for line in calibrate.readings(name, seeds, len(seeds), 0.0, "cuda"):
        assert _judged(cell, line["program"]), line
        assert "control" in line
        for readings in _failed(line).values():
            assert not _judged(cell, readings), line
