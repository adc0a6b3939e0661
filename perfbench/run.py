"""Run one cell of the benchmark once and print its result line.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout.  The cell's entry in ``BENCHMARK.json``
names its configuration and traffic mix (``spec.py``); the traffic's
driver (``traffic/<driver>.py``) builds the program from the seed, warms
it up, runs the window and checks what the window produced against the
plain reference.  ``--trace 0`` reports the cell's end-to-end metrics;
``--trace 1`` its per-layer ones, each read by its reader in
``layer_metrics/`` from the layer stamps of the window and a profiled
slice after it.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its limit;
the same numbers are the last lines of standard error.  The run exits
nonzero and prints no result without enough CUDA devices, when the
program cannot be imported, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from . import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mas_tpu")


def _environment(cell=None) -> None:
    """Caches inside the checkout, at fixed paths; no JAX through
    libraries that would load it; the CUDA allocator's settings that the
    cell's traffic mix names (before torch is imported)."""
    if cell is not None and "cuda_alloc_conf" in cell.traffic:
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = cell.traffic[
            "cuda_alloc_conf"]
    build = spec.ROOT / "build" / "perfbench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (``mas_tpu_torch`` is not ``mas_tpu``)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(names & set(FORBIDDEN))


def execute(name: str, seed: int, seconds: float, trace: bool, device,
            cell=None) -> dict:
    """One run of cell ``name`` on ``device`` (the chip check is the
    caller's); ``cell`` replaces the files' cell (tests)."""
    import torch

    from . import harness

    cell = spec.cell(name) if cell is None else cell
    driver = importlib.import_module(
        f"perfbench.traffic.{cell.traffic['driver']}")
    run = harness.Run(cell, seed, seconds, trace, torch.device(device))
    out = driver.run(run)
    limits = cell.limits
    out["compared"] = {k: {"value": v, "limit": limits.get(k)}
                       for k, v in out["checks"].items()}
    out["correct"] = all(c["limit"] is not None and c["value"] <= c["limit"]
                         for c in out["compared"].values())
    if trace:
        out["layer_metrics"] = read_layers(cell, out["obs"])
    return out


def read_layers(cell, obs: dict) -> dict:
    """{metric: value} of the cell's per-layer metrics that find
    something to read."""
    from . import layer_metrics

    found = {}
    for m in cell.per_layer:
        value = layer_metrics.read(m["name"], obs)
        if value is not None:
            found[m["name"]] = value
    return found


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


def result_line(cell, out: dict, trace: bool, setup_s: float) -> dict:
    import torch

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        values = out["layer_metrics"]
    else:
        values = dict(out["e2e"], setup_s=setup_s)
        values = {m["name"]: values[m["name"]] for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"],
            "metrics": {k: {"value": v, "unit": units[k]}
                        for k, v in values.items()},
            "device": device}
    if trace:
        s = out["obs"]["slice"]
        device.update(busy_s=s.busy_s, window_s=s.window_s,
                      power_limit=_power_limit())
        line["breakdown"] = {"device_ops": s.device_ops,
                             "idle_gaps": s.idle_gaps}
    line["checks"] = out["compared"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    print(f"perfbench: {PROCESS_START:.3f} process start", file=sys.stderr)
    cell = spec.cell(args.workload)
    _environment(cell)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has {have}", file=sys.stderr)
        return 2
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                  "cuda", cell)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}: no result", file=sys.stderr)
        return 3
    line = result_line(cell, out, bool(args.trace),
                       out["t0"] - PROCESS_START)
    for k, c in out["compared"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
