"""One run of one cell: its driver's window, the comparison that decides
``correct``, the per-layer readers (``--trace 1``) and the result line."""
from __future__ import annotations

import sys

from chipbench import common, compare, registry


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str, t_start: float,
             chips: int = 1) -> dict:
    """The run's result as a dict (``result_line``'s keys)."""
    out = common.Outcome(cell.config, cell.traffic, common.Spans(), t_start)
    kind = device
    if device.startswith("cuda"):
        import torch

        kind = torch.cuda.get_device_name(0)
        out.peaks = common.peaks_for(kind)
    registry.driver(cell.traffic["kind"]).run(cell, seed, seconds, trace, device, out)
    if out.trace is not None:
        out.trace.read()
    correct, checks = compare.judge(out.numbers, cell.limits)
    correct = correct and out.lost == 0
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = registry.metric_reader(m["name"])(out)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] in out.metrics:
                metrics[m["name"]] = {"value": out.metrics[m["name"]], "unit": m["unit"]}
            else:
                correct = False
                print(f"chipbench: {cell.name} reported no {m['name']}", file=sys.stderr)
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu", "kind": kind,
           "count": chips, "memory_peak_bytes": int(out.memory_peak)}
    breakdown = None
    if trace and out.trace is not None and out.trace.busy_s:
        dev["busy_s"] = out.trace.busy_s
        dev["window_s"] = out.trace.window_s
        breakdown = out.trace.breakdown()
    return {"correct": correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": dev, "checks": checks, "breakdown": breakdown,
            "numbers": out.numbers,
            "spans": {k: [round(x, 4) for x in out.spans.durations(k)][:400]
                      for k in ("step", "tick")}}
