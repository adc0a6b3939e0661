"""The readings that the limits of ``correct`` are set from, on the chip,
at a cell's own size:

    python3 -m perfbench.calibrate --workload <name> --seeds <n> ...
            [--control <k>] [--seconds <s>]

For each seed, one run of the cell (a short window, the same check) gives
the program's readings; for the first ``--control`` seeds, the control
(the reference in fp8 in the program's place, on the same prompts and
tokens or batches) and each planted fault that the driver offers give
theirs.  One JSON line a seed.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import run as bench
from . import spec


def readings(name: str, seeds, controls: int, seconds: float,
             device="cuda", cell=None):
    cell = spec.cell(name) if cell is None else cell
    for i, seed in enumerate(seeds):
        out = bench.execute(name, seed, seconds, False, device, cell)
        line = {"seed": seed, "program": out["checks"]}
        if i < controls:
            line["control"] = out["control"]()
            for fault, reading in out.get("faults", {}).items():
                line[fault] = reading()
        yield line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    bench._environment(spec.cell(args.workload))
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    for line in readings(args.workload, args.seeds, args.control,
                         args.seconds):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
