"""The harness finds each cell's configuration, traffic mix, limits,
driver, reference and per-layer readers by name, and ``BENCHMARK.json``
keeps to the shape its runner expects."""
import json
import math
import re

import pytest

from chipbench import common, registry

BENCH = registry.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = registry.cell(name)
    assert cell.chips == 1
    assert cell.config["name"] == next(w["config"] for w in BENCH["workloads"]
                                       if w["name"] == name)
    drv = registry.driver(cell.traffic["kind"])
    assert callable(drv.run)
    ref = registry.reference_module(cell.config)
    assert ref.param_specs(cell.config["sizes"])
    assert set(cell.limits) and all(v >= 0 for v in cell.limits.values())
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names
        assert callable(registry.metric_reader(m["name"]))


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][1] == "chipbench/run.py" and BENCH["paths"] == ["chipbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
    for c in BENCH["configs"]:
        conf = common.load_json(common.ROOT / c["file"])
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        e2e = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for w in m["workloads"]:
            assert "workloads" not in e2e or w in e2e["workloads"]
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"front door and scheduler", "engine", "model step", "kernels",
                      "device", "train loop"}
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_full_check_fits_the_time():
    n = 24
    assert (2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 180 + 1200 <= 43200


def test_seeds_large_and_stable():
    big = 2**31 + 12345
    assert common.seed_of(big, "weights") == common.seed_of(big, "weights")
    assert common.seed_of(big, "weights") != common.seed_of(big, "documents")
    assert 0 <= common.seed_of(big, "x") < 2**63


def test_percentile_counts_failures_last():
    assert common.percentile([1.0, 2.0, 3.0], 50) == 2.0
    assert common.percentile([1.0] * 19 + [math.inf], 95) == pytest.approx(1.0)
    assert common.percentile([1.0] * 9 + [math.inf], 95) == math.inf
