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

Beside the scheduler's and the engine's spans, the port's own code opens
program spans (``span``, cat ``"program"``) at the boundaries of the serve
engine, the front door's tick, the train step and the kernel builds. A
program span is recorded only while recording is on: while the thread
records into an attached ``JobTracer``'s buffer (``recording``: the
scheduler does it for a task whose job or worker has a tracer; code outside
the scheduler, such as a train loop, runs inside ``tracer.recording()``),
or while a ``torch.profiler`` session records, into the process-wide
``PROFILED`` buffer (the newest 32,768; the older ones dropped and counted).
Off, a span costs one check and allocates nothing. Each span also opens
``torch.profiler.record_function(name)`` for its interval; the train spans
record CUDA events at their start and end (``Span.device_ms``). Names,
args and nesting (children indented, per thread)::

    serve.tick             tick, retired, handoff_ms    streaming/serve.py
      engine.step          live, queue                  serving/engine.py
        engine.admit       prefills
          engine.prefill   rid, tokens, queue_ms
            launch         until bundle.prefill returns
              model.prefill  the bundle's own prefill   models/model_zoo.py
                moe.experts  tokens, assignments,        models/moe.py
                             experts_hit
            readback       int(argmax): the host blocked on the device
            splice
        engine.decode      live, graph
          launch           until decode_step returns, or the
                           graph's replay is enqueued
            moe.experts    tokens, assignments,          models/moe.py
                           experts_hit
          readback         argmax(...).cpu()
    feed.wait                                           data/pipeline.py
    train.step                                          launch/train.py
      train.forward, train.backward                     models/model_zoo.py
      train.optimizer      leaves
    kernel.build           library, seconds, nvcc       kernels/_cuda.py

``handoff_ms`` is the tick's wait from its submission (``JobTask.t_submit``)
to the span's start; ``queue_ms`` a request's from ``ServeEngine.submit``
to its prefill's start. ``graph`` says how the batched decode ran:
``"eager"`` (op by op), ``"capture"`` (op by op, then captured as a CUDA
graph) or ``"replay"`` (replayed from the graph: none of the model's own
spans, such as ``moe.experts``, is recorded inside it). The engine counts
the same in its ``decode_graph`` record (``serving/engine.py``):
``captures``, ``replays``, ``eager``, and ``why_eager``, why the engine
decodes eagerly (None before the first decode and while a graph is
captured). ``moe.experts`` is one dropless MoE layer (the
router, the grouped expert products, the weighted sum; one a layer): its
``tokens`` and routed ``assignments`` (tokens x k), and ``experts_hit``, the
experts given at least one. That count is made on the device and stays
there (``defer``) until ``settle`` reads every deferred count of the thread
in one copy: the engine calls it right after the readback that already
waited for the device, and only while recording.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import torch
from torch.autograd import profiler as _autograd_profiler


@dataclass(frozen=True)
class Span:
    name: str      # "compute", "lock_wait", "settle", "stage:...", ...
    cat: str       # "task" | "engine" | "sched"
    t0: float      # perf_counter seconds
    t1: float
    tid: int       # executing thread id
    args: dict = field(default_factory=dict)  # lane, kind, attempt, ...
    # a program span of device work: CUDA events recorded on the current
    # stream at its start and end (not exported)
    events: tuple = field(default=(), compare=False, repr=False)

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    @property
    def device_ms(self):
        """Milliseconds on the device between the span's CUDA events (the
        events must have completed), or None for a span without them."""
        return self.events[0].elapsed_time(self.events[1]) if self.events else None


class TraceBuffer:
    """Thread-safe span store for one tracer; with ``maxlen`` it keeps the
    newest ``maxlen`` spans and counts the older ones it drops."""

    def __init__(self, maxlen: int | None = None):
        self._lock = threading.Lock()
        self._spans: deque[Span] = deque(maxlen=maxlen)
        self.dropped = 0

    def add(self, span: Span):
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(span)

    def record(self, name: str, cat: str, t0: float, t1: float,
               tid: int | None = None, **args):
        self.add(Span(name, cat, t0, t1,
                      threading.get_ident() if tid is None else tid, args))

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def between(self, t0: float, t1: float) -> list[Span]:
        """The spans that lie wholly inside ``[t0, t1]``."""
        with self._lock:
            return [s for s in self._spans if t0 <= s.t0 and s.t1 <= t1]

    def __len__(self):
        with self._lock:
            return len(self._spans)

    def clear(self):
        with self._lock:
            self._spans.clear()
            self.dropped = 0


#: where program spans go while a ``torch.profiler`` session records and the
#: thread records into no tracer: the newest 32,768 (each with a few args)
PROFILED = TraceBuffer(maxlen=1 << 15)

_local = threading.local()  # .buffer: the tracer buffer this thread records into


class recording:
    """While the block runs, the calling thread records its program spans
    into ``buffer`` (a tracer's), or into none but ``PROFILED`` where
    ``buffer`` is None; the thread's earlier buffer is restored after."""

    __slots__ = ("buffer", "_prev")

    def __init__(self, buffer: TraceBuffer | None):
        self.buffer = buffer

    def __enter__(self):
        self._prev = getattr(_local, "buffer", None)
        _local.buffer = self.buffer
        return self.buffer

    def __exit__(self, *exc):
        _local.buffer = self._prev
        return False


class _Off:
    """The span of code that runs while recording is off: does nothing."""

    __slots__ = ()

    def __bool__(self):
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def settle() -> None:
    """Replace the calling thread's deferred span args (``_Open.defer``),
    device scalars, by their values, all in one copy to the host (which
    waits for the device where the caller has not)."""
    pending = getattr(_local, "pending", None)
    if not pending:
        return
    values = torch.stack([t for _, _, t in pending]).tolist()
    for (args, key, _), v in zip(pending, values):
        args[key] = v
    pending.clear()


class _Open:
    """A program span being recorded: ``args`` takes its counts."""

    __slots__ = ("buffer", "name", "args", "events", "t0", "_annotation")

    def __init__(self, buffer: TraceBuffer, name: str, device):
        self.buffer, self.name, self.args = buffer, name, {}
        self.events = ()
        device = getattr(device, "device", device)  # a tensor's
        if device is not None and torch.device(device).type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))

    def defer(self, key: str, value) -> None:
        """Set ``args[key]`` to ``value``, a 0-d tensor on the device, read
        at the thread's next ``settle`` (so recording adds no wait here)."""
        self.args[key] = value
        pending = getattr(_local, "pending", None)
        if pending is None:
            pending = _local.pending = []
        pending.append((self.args, key, value))

    def __bool__(self):
        return True

    def __enter__(self):
        self._annotation = torch.profiler.record_function(self.name)
        self._annotation.__enter__()
        if self.events:
            self.events[0].record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.events:
            self.events[1].record()
        self._annotation.__exit__(*exc)
        self.buffer.add(Span(self.name, "program", self.t0, t1, threading.get_ident(),
                             self.args, self.events))
        return False


def span(name: str, device=None):
    """A program span named ``name`` around a ``with`` block, recorded (with
    a ``torch.profiler.record_function`` of the same name, on the
    profiler's timeline) only while recording is on. ``device`` names the
    device of the block's work (or is a tensor on it); on a CUDA device the
    span takes CUDA events at its start and end (``Span.device_ms``). The
    span is falsy while off, so callers fill its ``args`` under ``if sp:``."""
    buffer = getattr(_local, "buffer", None)
    if buffer is None:
        if not _autograd_profiler._is_profiler_enabled:
            return _OFF
        buffer = PROFILED
    return _Open(buffer, name, device)


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
