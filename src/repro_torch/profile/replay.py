"""What-if replay (the port of ``repro.profile.replay``, pure python: the
same ``Trace`` gives the identical ``Schedule`` in both packages):
deterministically re-schedule a captured trace under a hypothesis
(docs/profiling.md §replay).

The shape of byteprofile-analysis's device-time replayer: a captured job
becomes a list of ``TaskRecord``s (duration + dependencies + lane), and an
event-driven list scheduler replays them against *hypothetical* resources
— a different gang split, a lane placement remap, a different speculative
timeout — reporting the predicted makespan without touching a device.

Replay is exact about structure and deliberately simple about physics:
a lane (a gang group's slice of the mesh, or a worker's serial job lock)
runs one task at a time; a task starts when its dependencies are done and
its lane is free; durations come from the capture (or from a ``CostModel``
for tasks the capture never ran). Determinism is a schema guarantee:
ties break on ``(ready_time, task id)``, so the same trace and the same
hypothesis produce the identical schedule — tested against the reference
in tests/test_torch_profile.py, and checked on the card by chip_smoke.py's
profile phase, which also reports the identity replay against the measured
makespan.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass(frozen=True)
class TaskRecord:
    """One captured task: everything replay needs, nothing it doesn't."""

    id: int
    name: str
    kind: str            # "stage" | "action" | "native" | "reshard" | "serve"
    lane: str            # gang-group label / worker name / "driver"
    dur_s: float         # measured body duration (lock wait excluded)
    deps: tuple = ()     # ids of tasks this one waits on
    settle_s: float = 0.0  # collective-await tail (overlappable on the lane)


@dataclass(frozen=True)
class Trace:
    tasks: tuple
    wall_s: float = 0.0  # measured makespan of the capture, when known

    def lanes(self) -> list[str]:
        return sorted({t.lane for t in self.tasks})


def capture(job) -> Trace:
    """Snapshot a finished (or running) job into a replayable Trace.

    Durations are task-body wall time (``t_start``→``t_end``; the lock
    wait is scheduling, not work — replay re-derives queueing from the
    hypothesis). The settle tail (``t_compute_end``→``t_settle_end``) is
    recorded separately because a dropped-lock settle does NOT occupy the
    lane — replay models it as lane-free tail time exactly like the live
    scheduler's one-way lock drop."""
    from repro_torch.profile.tracer import task_lane

    records = []
    t_first = t_last = None
    for t in sorted(job.tasks, key=lambda t: t.id):
        if not t.t_end:
            continue
        dur = max(0.0, t.t_end - t.t_start)
        settle = 0.0
        if getattr(t, "lock_dropped", False) and t.t_settle_end > t.t_compute_end:
            settle = min(dur, t.t_settle_end - t.t_compute_end)
        records.append(TaskRecord(
            id=t.id, name=t.name, kind=t.kind, lane=task_lane(t),
            dur_s=dur - settle, settle_s=settle,
            deps=tuple(d.id for d in t.deps),
        ))
        t_first = t.t_start if t_first is None else min(t_first, t.t_start)
        t_last = t.t_end if t_last is None else max(t_last, t.t_end)
    wall = (t_last - t_first) if records else 0.0
    return Trace(tasks=tuple(records), wall_s=wall)


@dataclass(frozen=True)
class Hypothesis:
    """What to vary. Identity (no fields set) replays the capture as-is.

    * ``lanes``: re-deal every gang-group lane round-robin onto ``lanes``
      synthetic lanes — "what if the job ran with gang=2 instead of 4?"
    * ``placement``: explicit lane→lane remap (consolidate or split named
      lanes); applied after ``lanes``.
    * ``speculative_timeout_s``: cap any task's duration at
      ``timeout + typical(kind)`` — the effect of a speculative duplicate
      finishing in typical time once the original exceeds the deadline.
    * ``scale``: multiply every duration (slower/faster hardware).
    """

    lanes: Optional[int] = None
    placement: dict = field(default_factory=dict)
    speculative_timeout_s: Optional[float] = None
    scale: float = 1.0


@dataclass(frozen=True)
class Schedule:
    makespan_s: float
    task_times: dict          # id -> (start_s, end_s)
    order: tuple              # ids in start order
    lanes: tuple              # lane labels used

    def explain(self) -> str:
        lines = [f"== replay schedule ({len(self.order)} tasks, "
                 f"makespan {self.makespan_s * 1e3:.1f}ms) =="]
        for tid in self.order:
            s, e = self.task_times[tid]
            lines.append(f"  t{tid}  [{s * 1e3:9.3f}, {e * 1e3:9.3f}] ms")
        return "\n".join(lines)


def _typical_by_kind(trace: Trace) -> dict:
    by: dict = {}
    for t in trace.tasks:
        by.setdefault(t.kind, []).append(t.dur_s)
    return {k: sorted(v)[len(v) // 2] for k, v in by.items()}


def _apply_hypothesis(trace: Trace, hyp: Hypothesis) -> list[TaskRecord]:
    tasks = list(trace.tasks)
    if hyp.lanes is not None and hyp.lanes > 0:
        # re-deal captured lanes round-robin onto n synthetic lanes,
        # in sorted-label order so the remap is deterministic
        remap = {lane: f"lane{i % hyp.lanes}"
                 for i, lane in enumerate(sorted({t.lane for t in tasks}))}
        tasks = [TaskRecord(t.id, t.name, t.kind, remap[t.lane], t.dur_s,
                            t.deps, t.settle_s) for t in tasks]
    if hyp.placement:
        tasks = [TaskRecord(t.id, t.name, t.kind,
                            hyp.placement.get(t.lane, t.lane), t.dur_s,
                            t.deps, t.settle_s) for t in tasks]
    if hyp.speculative_timeout_s is not None:
        typical = _typical_by_kind(trace)
        cut = hyp.speculative_timeout_s
        tasks = [TaskRecord(t.id, t.name, t.kind, t.lane,
                            min(t.dur_s, cut + typical.get(t.kind, 0.0)),
                            t.deps, t.settle_s) for t in tasks]
    if hyp.scale != 1.0:
        tasks = [TaskRecord(t.id, t.name, t.kind, t.lane, t.dur_s * hyp.scale,
                            t.deps, t.settle_s * hyp.scale) for t in tasks]
    return tasks


def simulate(trace: Trace, hypothesis: Hypothesis | None = None,
             price: Optional[Callable[[TaskRecord], float]] = None) -> Schedule:
    """Deterministic event-driven list scheduling of the trace under the
    hypothesis.

    Lanes are serial resources; a task occupies its lane for ``dur_s``,
    then its settle tail runs off-lane (the nonblocking overlap window) —
    dependents wait for settle, the lane does not. ``price(record)``
    overrides a record's duration (a ``CostModel`` pricing hypothetical
    work); ties break on (ready, lane-free, id) so identical inputs give
    the identical schedule."""
    hyp = hypothesis or Hypothesis()
    tasks = _apply_hypothesis(trace, hyp)
    by_id = {t.id: t for t in tasks}
    dependents: dict = {t.id: [] for t in tasks}
    remaining: dict = {}
    for t in tasks:
        deps = [d for d in t.deps if d in by_id]
        remaining[t.id] = len(deps)
        for d in deps:
            dependents[d].append(t.id)

    lane_free: dict = {t.lane: 0.0 for t in tasks}
    done_at: dict = {}       # id -> end incl. settle (what dependents see)
    task_times: dict = {}
    order: list = []
    ready: list = []         # (ready_s, id)
    for t in tasks:
        if remaining[t.id] == 0:
            heapq.heappush(ready, (0.0, t.id))

    scheduled = 0
    while ready:
        ready_s, tid = heapq.heappop(ready)
        t = by_id[tid]
        dur = t.dur_s if price is None else max(0.0, price(t))
        start = max(ready_s, lane_free[t.lane])
        lane_end = start + dur          # lane busy through the body
        end = lane_end + t.settle_s     # dependents wait for the settle too
        lane_free[t.lane] = lane_end
        done_at[tid] = end
        task_times[tid] = (start, end)
        order.append(tid)
        scheduled += 1
        for d in dependents[tid]:
            remaining[d] -= 1
            if remaining[d] == 0:
                ready_d = max((done_at[x] for x in by_id[d].deps
                               if x in done_at), default=end)
                heapq.heappush(ready, (ready_d, d))

    # cycles or missing deps leave tasks unscheduled — surface, don't hang
    if scheduled != len(tasks):
        stuck = sorted(set(by_id) - set(done_at))
        raise ValueError(f"replay: {len(stuck)} tasks never became ready "
                         f"(dependency cycle?): {stuck[:8]}")
    makespan = max(done_at.values(), default=0.0)
    return Schedule(makespan_s=makespan, task_times=task_times,
                    order=tuple(order), lanes=tuple(sorted(lane_free)))


def predicted_vs_measured(job, hypothesis: Hypothesis | None = None) -> dict:
    """Convenience for benchmarks/tests: capture ``job``, replay under the
    (identity by default) hypothesis, report predicted vs measured
    makespan and their min/max accuracy ratio."""
    trace = capture(job)
    sched = simulate(trace, hypothesis)
    pred, meas = sched.makespan_s, trace.wall_s
    acc = (min(pred, meas) / max(pred, meas)) if pred > 0 and meas > 0 else 0.0
    return {"predicted_s": pred, "measured_s": meas, "accuracy": acc,
            "tasks": len(trace.tasks), "lanes": len(trace.lanes())}
