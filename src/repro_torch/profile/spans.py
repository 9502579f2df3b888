"""Trace spans and the Chrome-trace exporter (the port of ``repro.profile.spans``;
docs/profiling.md §schema; the same schema, field for field).

A ``Span`` is one closed interval of wall time on one thread: a task body,
its lock wait, its collective settle, or an engine-level stage/node
compute. ``TraceBuffer`` collects spans thread-safely and renders the
Chrome trace event format (the ``chrome://tracing`` / Perfetto JSON
schema: complete ``"X"`` events with microsecond ``ts``/``dur``, thread
metadata ``"M"`` events).

Threads, not lanes, are the nesting domain: after a settle hands a task's
lock off (core/job.py ``_settle``), the *next* task on the same lane
overlaps the first task's collective await — so same-lane spans may
interleave, while same-thread spans always nest. The exporter therefore
keys ``tid`` on the executing thread and carries the lane/gang label in
``args["lane"]``, which is what the schema tests validate
(tests/test_torch_profile.py).
"""
from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Span:
    name: str      # "compute", "lock_wait", "settle", "stage:...", ...
    cat: str       # "task" | "engine" | "sched"
    t0: float      # perf_counter seconds
    t1: float
    tid: int       # executing thread id
    args: dict = field(default_factory=dict)  # lane, kind, attempt, ...

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


class TraceBuffer:
    """Append-only, thread-safe span store for one tracer."""

    def __init__(self):
        self._lock = threading.Lock()
        self._spans: list[Span] = []

    def add(self, span: Span):
        with self._lock:
            self._spans.append(span)

    def record(self, name: str, cat: str, t0: float, t1: float,
               tid: int | None = None, **args):
        self.add(Span(name, cat, t0, t1,
                      threading.get_ident() if tid is None else tid, args))

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def __len__(self):
        with self._lock:
            return len(self._spans)

    def clear(self):
        with self._lock:
            self._spans.clear()


def to_chrome(spans: list[Span], process_name: str = "ignis") -> dict:
    """Render spans as a Chrome trace JSON object.

    ``ts``/``dur`` are microseconds relative to the earliest span (Chrome
    renders absolute perf_counter values poorly); every distinct tid gets
    a ``thread_name`` metadata event naming the lanes it ran."""
    if not spans:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    epoch = min(s.t0 for s in spans)
    events: list[dict] = [{
        "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
        "args": {"name": process_name},
    }]
    lanes_by_tid: dict[int, set] = {}
    for s in spans:
        lanes_by_tid.setdefault(s.tid, set()).add(s.args.get("lane", "driver"))
    for tid, lanes in sorted(lanes_by_tid.items()):
        events.append({
            "name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
            "args": {"name": "worker [" + ", ".join(sorted(lanes)) + "]"},
        })
    for s in sorted(spans, key=lambda s: (s.t0, -s.t1)):
        events.append({
            "name": s.name, "cat": s.cat, "ph": "X", "pid": 0, "tid": s.tid,
            "ts": round((s.t0 - epoch) * 1e6, 3),
            "dur": round(max(0.0, s.dur) * 1e6, 3),
            "args": dict(s.args),
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def save_chrome(spans: list[Span], path: str, process_name: str = "ignis"):
    with open(path, "w", encoding="utf-8") as f:
        json.dump(to_chrome(spans, process_name), f)


def validate(trace: dict) -> list[str]:
    """Schema violations in a Chrome trace object: malformed events,
    negative durations, same-thread spans that overlap without nesting.
    Empty list = valid. Used by tests and the bench harness — an exported
    timeline that Chrome renders misleadingly should fail loudly here."""
    problems: list[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    by_tid: dict[int, list[dict]] = {}
    for i, e in enumerate(events):
        ph = e.get("ph")
        if ph == "M":
            continue
        if ph != "X":
            problems.append(f"event {i}: unexpected ph {ph!r}")
            continue
        for k in ("name", "ts", "dur", "tid", "pid"):
            if k not in e:
                problems.append(f"event {i}: missing {k!r}")
        if e.get("dur", 0) < 0:
            problems.append(f"event {i} ({e.get('name')}): negative dur")
        if e.get("ts", 0) < 0:
            problems.append(f"event {i} ({e.get('name')}): negative ts")
        by_tid.setdefault(e.get("tid", 0), []).append(e)
    for tid, evs in by_tid.items():
        evs = sorted(evs, key=lambda e: (e["ts"], -(e["ts"] + e["dur"])))
        stack: list[tuple] = []  # (end, name)
        for e in evs:
            t0, t1 = e["ts"], e["ts"] + e["dur"]
            while stack and stack[-1][0] <= t0 + 1e-9:
                stack.pop()
            if stack and t1 > stack[-1][0] + 1e-6:
                problems.append(
                    f"tid {tid}: {e['name']!r} [{t0},{t1}] overlaps "
                    f"{stack[-1][1]!r} (ends {stack[-1][0]}) without nesting")
            stack.append((t1, e["name"]))
    return problems
