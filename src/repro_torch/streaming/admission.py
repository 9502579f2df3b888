"""Admission control — the multi-tenant overload policy (docs/streaming.md).

One controller is shared by every pump/front-door of a serving deployment;
it decides, per micro-batch (or per serve request), between three outcomes:

  ``admit``  a slot is available globally AND within the tenant's quota
  ``wait``   over a bound, policy ``block`` → the CALLER applies
             backpressure (the driver-side pump parks on its own oldest
             future; worker threads are never blocked)
  ``shed``   over a bound, policy ``shed`` → the unit of work is dropped,
             counted, and the stream/serve queue moves on

Bounds come from ``ignis.stream.*`` properties. The ``stream.admit`` fault
site is wired here: an injected fault forces a ``shed`` decision (overload
is a POLICY outcome, not a task error — nothing retries).

Determinism note: only policy ``block`` composes with the exactly-once
replay guarantees — a shed decision depends on instantaneous load, which a
replayed run will not reproduce. Shed mode trades determinism for bounded
latency; the telemetry keeps the loss visible (docs/streaming.md).
"""
from __future__ import annotations

import threading
from typing import Optional

from repro_torch.core import faults


class AdmissionController:
    def __init__(self, props=None, *, max_inflight: Optional[int] = None,
                 tenant_quota: Optional[int] = None,
                 queue_depth: Optional[int] = None, policy: Optional[str] = None):
        get_int = props.get_int if props is not None else lambda k, d: d
        get = props.get if props is not None else lambda k, d: d
        self.max_inflight = max_inflight if max_inflight is not None else \
            get_int("ignis.stream.max.inflight", 8)
        self.tenant_quota = tenant_quota if tenant_quota is not None else \
            get_int("ignis.stream.tenant.quota", 4)
        self.queue_depth = queue_depth if queue_depth is not None else \
            get_int("ignis.stream.queue.depth", 16)
        self.policy = policy if policy is not None else \
            get("ignis.stream.shed.policy", "block")
        if self.policy not in ("block", "shed"):
            raise ValueError(f"unknown shed policy {self.policy!r}")
        self._cond = threading.Condition()
        self._inflight: dict[str, int] = {}
        self._waiting = 0

    # ------------------------------------------------------------------
    @property
    def inflight(self) -> int:
        with self._cond:
            return sum(self._inflight.values())

    def tenant_inflight(self, tenant: str) -> int:
        with self._cond:
            return self._inflight.get(tenant, 0)

    # ------------------------------------------------------------------
    def try_admit(self, tenant: str) -> str:
        """One admission decision: ``admit`` | ``wait`` | ``shed``."""
        try:
            faults.check("stream.admit", tenant=tenant)
        except faults.FaultInjected:
            return "shed"  # injected overload: policy-forced shed, no retry
        with self._cond:
            total = sum(self._inflight.values())
            mine = self._inflight.get(tenant, 0)
            if total < self.max_inflight and mine < self.tenant_quota:
                self._inflight[tenant] = mine + 1
                return "admit"
            if self.policy == "shed" or self._waiting >= self.queue_depth:
                return "shed"
            return "wait"

    def wait_for_change(self, timeout: float = 0.05):
        """Park until some slot is released (bounded — a caller in ``wait``
        with nothing of its own in flight must not spin; another tenant's
        commit is what frees the global bound)."""
        with self._cond:
            self._waiting += 1
            try:
                self._cond.wait(timeout)
            finally:
                self._waiting -= 1

    def release(self, tenant: str):
        with self._cond:
            n = self._inflight.get(tenant, 0)
            if n <= 1:
                self._inflight.pop(tenant, None)
            else:
                self._inflight[tenant] = n - 1
            self._cond.notify_all()
