"""Helpers of the benchmark's CPU tests: each cell of ``BENCHMARK.json`` cut
to a size the CPU runs in seconds (widths, depth, vocabulary, batch,
lengths; the same files otherwise), and limits for it."""
import copy
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: limits at the tiny size, between the program's readings on the CPU and
#: the fp8 control's (which read 10x or more above them)
TINY_LIMITS = {
    "train": {"batch_mismatch": 0, "loss_gap": 2e-4, "grad_gap": 0.015, "change_gap": 0.04},
    "serve": {"length_mismatch": 0, "max_gap": 0.02},
}


#: a cell held out of ``BENCHMARK.json`` (``PERF.md``, Open questions) whose
#: files stay under ``chipbench/``: tested here at the reduced size as the
#: others are
HELD_OUT = {
    "configs": [{"name": "mamba2-780m", "file": "chipbench/configs/mamba2-780m.json"}],
    "workloads": [{"name": "mamba2-780m.train-4x2048", "config": "mamba2-780m",
                   "traffic": "train-4x2048", "chips": 1}],
}


def tiny_cell(name: str, dtype: str = "bfloat16"):
    from chipbench import registry

    bench = registry.benchmark()
    bench = dict(bench, **{k: bench[k] + v for k, v in HELD_OUT.items()})
    c = registry.cell(name, bench)
    conf, mix = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    sz = conf["sizes"]
    if conf["family"] == "dense":
        sz.update(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
                  vocab_size=512)
    else:
        sz.update(num_layers=2, d_model=64, ssm_state=16, ssm_headdim=16, ssm_chunk=16,
                  vocab_size=512)
    sz["param_dtype"] = dtype
    conf["program"] = dict(conf["program"], **{k: v for k, v in sz.items()
                                               if k not in ("dt_min", "dt_max")})
    if mix["kind"] == "train":
        mix.update(batch=2, seq_len=64, rows=16,
                   documents=dict(mix["documents"], median=40, min=8, max=200))
    else:
        mix.update(clients=4, slots=4, cache_len=128, requests=64,
                   prompt=dict(mix["prompt"], median=32, min=16, max=96),
                   output=dict(mix["output"], median=8, min=4, max=24),
                   check=dict(min_tokens=30, max_requests=4), min_retired=8)
    c.config, c.traffic = conf, mix
    c.limits = dict(TINY_LIMITS[mix["kind"]])
    return c


@pytest.fixture
def tiny():
    return tiny_cell
