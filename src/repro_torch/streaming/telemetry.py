"""Per-tenant streaming/serving telemetry (the port of
``repro.streaming.telemetry``; docs/streaming.md).

One ``StreamTelemetry`` is shared by every pump and front door of a
deployment; attach it to an ``IJob`` (``telemetry.attach(job)``) and the
counters surface under the ``"stream"`` section of ``job.stats()`` next to
the scheduler's own numbers. ``summary()`` renders the explain-style text
block (one line per tenant: admitted/shed/completed, replay count, latency
p50/p99)."""
from __future__ import annotations

import threading

import numpy as np


class _TenantStats:
    __slots__ = ("admitted", "shed", "completed", "replayed", "latencies_ms")

    def __init__(self):
        self.admitted = 0
        self.shed = 0
        self.completed = 0
        self.replayed = 0  # sum of extra scheduler attempts over all commits
        self.latencies_ms: list[float] = []


def _pct(xs: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


class StreamTelemetry:
    def __init__(self):
        self._lock = threading.Lock()
        self._tenants: dict[str, _TenantStats] = {}

    def _t(self, tenant: str) -> _TenantStats:
        st = self._tenants.get(tenant)
        if st is None:
            st = self._tenants[tenant] = _TenantStats()
        return st

    # ---- recording (called from pump threads and done-callbacks) -------
    def record_admitted(self, tenant: str, n: int = 1):
        with self._lock:
            self._t(tenant).admitted += n

    def record_shed(self, tenant: str, n: int = 1):
        with self._lock:
            self._t(tenant).shed += n

    def record_completed(self, tenant: str, latency_ms: float, replays: int = 0):
        with self._lock:
            st = self._t(tenant)
            st.completed += 1
            st.replayed += replays
            st.latencies_ms.append(float(latency_ms))

    # ---- reading -------------------------------------------------------
    def snapshot(self, controller=None) -> dict:
        with self._lock:
            tenants = {
                name: {
                    "admitted": st.admitted,
                    "shed": st.shed,
                    "completed": st.completed,
                    "batches_replayed": st.replayed,
                    "inflight": (controller.tenant_inflight(name)
                                 if controller is not None else 0),
                    "latency_p50_ms": _pct(st.latencies_ms, 50),
                    "latency_p99_ms": _pct(st.latencies_ms, 99),
                }
                for name, st in sorted(self._tenants.items())
            }
        totals = {
            "admitted": sum(t["admitted"] for t in tenants.values()),
            "shed": sum(t["shed"] for t in tenants.values()),
            "completed": sum(t["completed"] for t in tenants.values()),
            "batches_replayed": sum(t["batches_replayed"] for t in tenants.values()),
            "inflight": controller.inflight if controller is not None else 0,
        }
        return {"tenants": tenants, **totals}

    def summary(self, controller=None) -> str:
        snap = self.snapshot(controller)
        lines = [
            f"== stream telemetry ({len(snap['tenants'])} tenants, "
            f"{snap['completed']} completed, {snap['shed']} shed, "
            f"{snap['batches_replayed']} replayed) =="
        ]
        for name, t in snap["tenants"].items():
            lines.append(
                f"  {name}: admitted={t['admitted']} shed={t['shed']} "
                f"completed={t['completed']} replayed={t['batches_replayed']} "
                f"inflight={t['inflight']} "
                f"p50={t['latency_p50_ms']:.2f}ms p99={t['latency_p99_ms']:.2f}ms"
            )
        return "\n".join(lines)

    def attach(self, job, controller=None):
        """Surface this telemetry under ``job.stats()['stream']``."""
        job.stream = lambda: self.snapshot(controller)
        return job
