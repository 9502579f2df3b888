"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names ``jax``, ``jaxlib``, ``flax``, ``repro``, compared whole:
``repro_torch`` is allowed), and the reference loads nothing of the port.
Each check runs in a fresh interpreter, since the test process itself may
hold JAX."""
import json
import os
import subprocess
import sys

import pytest

from chipbench import common, registry

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]

HARNESS = """
import json, sys
sys.argv = ["run.py"]
import chipbench.run
from chipbench import calibrate, harness, registry
cell = registry.cell(sys.argv_cell)
drv = registry.driver(cell.traffic["kind"])
for m in cell.per_layer:
    registry.metric_reader(m["name"])
registry.reference_module(cell.config)
import repro_torch.launch.train, repro_torch.data.pipeline, repro_torch.models
import repro_torch.serving, repro_torch.streaming, repro_torch.core, repro_torch.kernels
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys
import chipbench.reference.dense, chipbench.reference.ssm, chipbench.reference.train
import chipbench.reference.precision
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def loaded(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=f"{common.ROOT}{os.pathsep}{common.ROOT / 'src'}")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, cwd=common.ROOT, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("name", CELLS)
def test_harness_loads_no_jax(name):
    tops = loaded(HARNESS.replace("sys.argv_cell", repr(name)))
    assert "repro_torch" in tops and "chipbench" in tops
    assert not tops & set(common.FORBIDDEN_MODULES), tops & set(common.FORBIDDEN_MODULES)


def test_reference_loads_nothing_of_the_port():
    tops = loaded(REFERENCE)
    assert "torch" in tops
    assert not tops & ({"repro_torch"} | set(common.FORBIDDEN_MODULES))


def test_run_refuses_without_a_card_or_the_program(tmp_path):
    import shutil

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here: run.py would run the cell")
    cmd = [sys.executable, "chipbench/run.py", "--workload", CELLS[0], "--seed", "1",
           "--seconds", "1"]
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=common.ROOT, timeout=120)
    assert r.returncode != 0 and not r.stdout.strip()
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(common.HERE, tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=tmp_path, timeout=120, env=env)
    assert r.returncode != 0 and not r.stdout.strip()
    assert "not in this checkout" in r.stderr
