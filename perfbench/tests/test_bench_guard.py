"""No JAX in a run, and no run without the program."""

import os
import shutil
import subprocess
import sys

from perfbench import run, spec

IMPORT_PATH = """
import sys, importlib
from perfbench import run, spec, calibrate, layer_metrics
for w in spec.benchmark()["workloads"]:
    c = spec.cell(w["name"])
    importlib.import_module("perfbench.traffic." + c.traffic["driver"])
    for m in c.per_layer:
        layer_metrics.reader(m["name"])
run._environment()
print(run.forbidden_modules())
"""


def _python(code, cwd):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_the_import_path_loads_no_jax():
    out = _python(IMPORT_PATH, spec.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_top_level_names_compared_whole():
    mods = {"mas_tpu_torch": 1, "mas_tpu_torch.ops": 1, "jaxtyping": 1,
            "flaxen": 1}
    assert run.forbidden_modules(mods) == []
    mods.update({"jax.numpy": 1, "mas_tpu": 1, "flax.linen": 1})
    assert run.forbidden_modules(mods) == ["flax", "jax", "mas_tpu"]


def test_no_result_without_the_program(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.PKG, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _python("from perfbench import run\n"
                  "run.execute('sample_256.b384', 3, 0.0, False, 'cpu')",
                  tmp_path)
    assert out.returncode != 0
    assert "mas_tpu_torch" in out.stderr
    assert out.stdout == ""
