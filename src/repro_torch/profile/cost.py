"""The cost model's history half: learn from having run work.

Observed durations of tasks keyed by structural signature (``node_sig``) —
the empirical side that speculative-timeout derivation reads — and the
static path of the fusion policy (``should_fuse``: a first-sighting chain
fuses only if one run already repays the stage build). Every worker carries
one; the scheduler feeds it task history.

Pricing work before it runs (the reference prices jaxprs and compiled HLO)
is not part of this module yet.
"""
from __future__ import annotations

import statistics
import threading
from collections import deque
from dataclasses import dataclass


@dataclass(frozen=True)
class DeviceParams:
    """The constants the fusion policy weighs: per-call dispatch overhead
    against the cost of building a fused stage, per operator."""

    dispatch_s: float = 50e-6
    compile_s_per_op: float = 8e-3


class CostModel:
    """See module docstring. Thread-safe: gang tasks consult one model from
    several scheduler threads at once."""

    def __init__(self, params: DeviceParams | None = None, history: int = 64):
        self.params = params or DeviceParams()
        self._lock = threading.Lock()
        self._history = history
        self._task_durs: dict = {}        # key -> deque[float seconds]
        self._stage_sightings: dict = {}  # stage signature -> times planned
        self.stats = {
            "fuse_decisions": 0,
            "fuse_deferrals": 0,
            "auto_timeouts": 0,
            "tasks_observed": 0,
        }

    # ------------------------------------------------------------------
    # cost-aware fusion boundaries (DagEngine.plan)
    # ------------------------------------------------------------------
    def should_fuse(self, signature, n_ops: int, nblocks: int = 1) -> bool:
        """Is building this narrow chain into one fused stage worth it?

        On the FIRST sighting of a signature the build is unamortised — fuse
        only if this single run already saves more dispatch overhead
        (``(n_ops - 1) x nblocks`` calls) than the build costs. From the
        second sighting on, the plan cache amortises it: always fuse."""
        p = self.params
        with self._lock:
            seen = self._stage_sightings.get(signature, 0)
            self._stage_sightings[signature] = seen + 1
            self.stats["fuse_decisions"] += 1
            if seen > 0:
                return True
            saved = (max(0, n_ops - 1)) * max(1, nblocks) * p.dispatch_s
            if saved >= n_ops * p.compile_s_per_op:
                return True
            self.stats["fuse_deferrals"] += 1
            return False

    def peek_fuse(self, signature) -> bool:
        """``should_fuse`` without recording a sighting — for ``explain()``."""
        with self._lock:
            return self._stage_sightings.get(signature, 0) > 0

    # ------------------------------------------------------------------
    # cost-derived speculative timeouts (IJob._evaluator)
    # ------------------------------------------------------------------
    def observe_task(self, key, dur_s: float):
        """Record one observed task duration under a structural key —
        typically ``(kind, node_sig(node))``."""
        if dur_s < 0:
            return
        with self._lock:
            q = self._task_durs.get(key)
            if q is None:
                q = self._task_durs[key] = deque(maxlen=self._history)
            q.append(dur_s)
            self.stats["tasks_observed"] += 1

    def typical_s(self, key) -> float | None:
        """Median observed duration for ``key`` (None with no history)."""
        with self._lock:
            q = self._task_durs.get(key)
            if not q:
                return None
            return statistics.median(q)

    def speculative_timeout_s(self, key, factor: float = 3.0,
                              default_s: float = 30.0) -> float:
        """The straggler deadline for a task: ``factor x`` its typical
        observed duration, floored at 50 ms, falling back to ``default_s``
        before any history exists."""
        typical = self.typical_s(key)
        with self._lock:
            self.stats["auto_timeouts"] += 1
        if typical is None:
            return default_s
        return max(0.05, factor * typical)

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {**self.stats,
                    "task_keys": len(self._task_durs),
                    "stage_signatures": len(self._stage_sightings)}
