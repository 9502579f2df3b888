"""Finds what belongs to a cell by name, in files of its own, from
``BENCHMARK.json``:

- the configuration: the file that ``BENCHMARK.json`` names for it;
- the traffic mix: ``chipbench/traffic/<traffic>.json``;
- the limits of the comparison that decides ``correct``:
  ``chipbench/limits/<cell>.json``;
- the driver of the mix's kind of window: ``chipbench/drivers/<kind>.py``;
- each per-layer metric's reader: ``chipbench/metrics/<metric>.py``;
- the configuration's plain reference: ``chipbench/reference/<reference>.py``.

So a configuration, a mix, a cell or a metric is added by adding files and
entries, with no edit to a file that is there.
"""
from __future__ import annotations

import importlib
import importlib.util
from dataclasses import dataclass

from chipbench.common import HERE, ROOT, load_json


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list


def benchmark(root=ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None, root=ROOT) -> Cell:
    bench = bench or benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r}; known: {sorted(by_name)}")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root / conf["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in reported and _reports(m, name)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e, per_layer)


def driver(kind: str):
    return importlib.import_module(f"chipbench.drivers.{kind}")


def reference_module(config: dict):
    return importlib.import_module(f"chipbench.reference.{config['reference']}")


def metric_reader(name: str):
    """The ``read(run)`` of ``chipbench/metrics/<name>.py`` (a metric's name
    may hold dots, so the file is loaded by its path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"chipbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
