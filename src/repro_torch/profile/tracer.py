"""JobTracer — the per-job/per-worker profiler (the port of
``repro.profile.tracer``; docs/profiling.md).

Attach to a job before running actions; export a Chrome-trace timeline
after::

    tracer = JobTracer()
    tracer.attach(job)            # task spans: lock-wait/compute/settle
    tracer.attach_worker(worker)  # engine spans + metrics "profile/" mount
    ... run actions ...
    tracer.save("trace.json")     # open in chrome://tracing / Perfetto

The tasks of an attached job or worker also record the port's program
spans (``spans.span``: the serve engine, the front door's tick) into the
tracer's buffer; code that runs outside the scheduler, such as a train
loop, records them inside ``with tracer.recording():``.

Task phases come from timestamps the scheduler already stamps on each
``JobTask`` (core/job.py): ``t_start``→``t_end`` is the task body,
``t_lock_wait`` the serialisation-lock wait that preceded it,
``t_compute_end``→``t_settle_end`` the collective settle (the window the
nonblocking design overlaps with the next task — visible in the timeline
as a settle span running beside a peer's compute). Engine spans
(fused-stage and wide-node computes) stream in live through the
``DagEngine.trace_hook`` while attached. The tracer also feeds every
finished task's duration into its ``CostModel``'s history, which is what
``ignis.task.speculative.timeout=auto`` reads.
"""
from __future__ import annotations

import threading
import time

from repro_torch.profile.cost import CostModel
from repro_torch.profile.spans import Span, TraceBuffer, recording, save_chrome, to_chrome


def task_lane(task) -> str:
    """The lane label for a task: its gang group's label (matching
    ``job.explain()``'s ``group=`` annotation), else its worker name,
    else the driver."""
    if task.group is not None:
        return task.group.label()
    if task.worker is not None:
        return task.worker.name
    return "driver"


class JobTracer:
    """Collects spans for any number of jobs/workers; one buffer, one
    timeline. Thread-safe (the scheduler completes tasks on pool threads)."""

    def __init__(self, cost_model: CostModel | None = None):
        self.buffer = TraceBuffer()
        self.cost = cost_model or CostModel()
        self._lock = threading.Lock()
        self._jobs: list = []
        self._workers: list = []
        self._t0 = time.perf_counter()

    # ------------------------------------------------------------------
    # attachment
    # ------------------------------------------------------------------
    def attach(self, job) -> "JobTracer":
        """Trace ``job``: the scheduler notifies this tracer as each task
        resolves (span emission + cost-history observation)."""
        job.tracer = self
        with self._lock:
            self._jobs.append(job)
        return self

    def attach_worker(self, worker) -> "JobTracer":
        """Trace ``worker``'s engine (fused-stage/wide-node spans via the
        ``DagEngine.trace_hook``) and mount ``profile/`` on its metrics
        tree; also adopts the worker engine's cost model so observations
        and decisions share state."""
        worker.engine.trace_hook = self.buffer.record
        worker.tracer = self  # the scheduler records its tasks' program spans here
        if getattr(worker.engine, "cost_model", None) is not None:
            self.cost = worker.engine.cost_model
        if hasattr(worker, "mount_metrics"):
            worker.mount_metrics("profile", self.summary)
        with self._lock:
            self._workers.append(worker)
        return self

    def detach(self):
        with self._lock:
            jobs, self._jobs = self._jobs, []
            workers, self._workers = self._workers, []
        for job in jobs:
            if job.tracer is self:
                job.tracer = None
        for w in workers:
            if getattr(w.engine, "trace_hook", None) == self.buffer.record:
                w.engine.trace_hook = None
            if getattr(w, "tracer", None) is self:
                w.tracer = None

    def recording(self) -> recording:
        """A context in which the calling thread records its program spans
        (``spans.span``) into this tracer's buffer."""
        return recording(self.buffer)

    # ------------------------------------------------------------------
    # scheduler callback (core/job.py `_run_locked` end)
    # ------------------------------------------------------------------
    def task_done(self, task):
        """Emit the task's phase spans from its stamped timestamps and feed
        the cost history. Called once per resolved task, failed or not."""
        if not task.t_end:
            return
        lane = task_lane(task)
        tid = task.tid or 0
        args = {"lane": lane, "kind": task.kind, "task": task.name,
                "state": task.state, "attempt": task.attempt}
        if task.t_lock_wait > 0:
            self.buffer.add(Span("lock_wait", "sched",
                                 task.t_start - task.t_lock_wait,
                                 task.t_start, tid, dict(args)))
        # whole-task span; compute/settle children nest inside it
        self.buffer.add(Span(task.name, "task", task.t_start, task.t_end,
                             tid, dict(args)))
        t_compute_end = task.t_compute_end or task.t_end
        self.buffer.add(Span("compute", "task", task.t_start,
                             min(t_compute_end, task.t_end), tid, dict(args)))
        if task.t_settle_end > t_compute_end:
            self.buffer.add(Span("settle", "task", t_compute_end,
                                 min(task.t_settle_end, task.t_end), tid,
                                 {**args, "overlapped": task.lock_dropped}))
        key = self.task_key(task)
        if key is not None:
            self.cost.observe_task(key, task.t_end - task.t_start)

    @staticmethod
    def task_key(task):
        """The cost-history key for a task — shared with the scheduler's
        own observation path so both feed one history."""
        from repro_torch.core.job import task_history_key

        return task_history_key(task)

    # ------------------------------------------------------------------
    # export / introspection
    # ------------------------------------------------------------------
    def spans(self) -> list[Span]:
        return self.buffer.spans()

    def to_chrome(self) -> dict:
        return to_chrome(self.buffer.spans())

    def save(self, path: str):
        save_chrome(self.buffer.spans(), path)

    def summary(self) -> dict:
        """The ``profile/`` metrics namespace: span counts and per-phase
        wall totals (milliseconds)."""
        spans = self.buffer.spans()
        task_spans = [s for s in spans if s.cat == "task" and s.name
                      not in ("compute", "settle")]
        by = lambda name: sum(s.dur for s in spans if s.name == name)
        return {
            "spans": len(spans),
            "tasks": len(task_spans),
            "engine_spans": sum(1 for s in spans if s.cat == "engine"),
            "compute_ms": by("compute") * 1e3,
            "lock_wait_ms": by("lock_wait") * 1e3,
            "settle_ms": by("settle") * 1e3,
            "makespan_ms": ((max(s.t1 for s in spans) - min(s.t0 for s in spans)) * 1e3
                            if spans else 0.0),
            "cost": self.cost.snapshot(),
        }
