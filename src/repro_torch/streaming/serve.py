"""ServeFrontDoor — continuous-batching decode ticks as scheduler tasks
(the port of ``repro.streaming.serve``; docs/streaming.md).

Wraps a ``repro_torch.serving.engine.ServeEngine``: each decode tick becomes a job task
(kind ``serve``) chained on the previous tick and pinned to a dedicated
gang group, so serving shares the ``JobScheduler`` DAG with ingestion pumps
and ordinary dataflow jobs — ticks serialize under their group lock while
everything else overlaps (the paper's hybrid pattern at serving time).

Admission: a bounded front-door queue (``ignis.serve.queue.depth``) sheds
requests beyond the bound — overload is a policy outcome, counted per
tenant in the shared telemetry, never an error. A tick that dies BEFORE its
decode (the ``job.task`` fault site fires ahead of the task fn) retries via
the scheduler; the engine's state advances exactly once per successful
tick, so retried ticks never double-decode.
"""
from __future__ import annotations

import functools
import threading
import time
from typing import Optional

from repro_torch.core.job import IFuture, JobTask
from repro_torch.profile.spans import span
from repro_torch.serving.engine import Request


class ServeTicket:
    """Front-door handle for one submitted request: resolves to the retired
    ``Request`` (or marks the request shed at admission)."""

    __slots__ = ("request", "tenant", "shed", "t_submit", "latency_ms", "_event")

    def __init__(self, request: Optional[Request], tenant: str, shed: bool = False):
        self.request = request
        self.tenant = tenant
        self.shed = shed
        self.t_submit = time.perf_counter()
        self.latency_ms = 0.0
        self._event = threading.Event()
        if shed:
            self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Optional[Request]:
        if not self._event.wait(timeout):
            raise TimeoutError("request still in flight")
        return None if self.shed else self.request

    def _resolve(self):
        self.latency_ms = (time.perf_counter() - self.t_submit) * 1e3
        self._event.set()


class ServeFrontDoor:
    def __init__(self, engine, worker, *, group=None, name: str = "serve",
                 job=None, scheduler=None, telemetry=None, props=None):
        from repro_torch.core.job import default_scheduler
        from repro_torch.streaming.telemetry import StreamTelemetry

        self.engine = engine
        self.worker = worker
        self.group = group
        self.name = name
        # an attached IJob records tick tasks for stats()/explain() — the
        # DAG view of serving and ingestion sharing one scheduler
        self.job = job
        self.scheduler = (scheduler if scheduler is not None
                          else job.scheduler if job is not None
                          else default_scheduler())
        self.telemetry = telemetry or StreamTelemetry()
        props = props if props is not None else worker.cluster.props
        self.queue_depth = props.get_int("ignis.serve.queue.depth", 64)
        self._lock = threading.Lock()
        self._tickets: dict[int, ServeTicket] = {}
        self._next_rid = 0
        self._tick_no = 0
        self._prev_tick: Optional[JobTask] = None
        self.completed: list[ServeTicket] = []

    # ------------------------------------------------------------------
    def submit(self, prompt, *, max_new_tokens: int = 32, eos_id=None,
               tenant: str = "t0") -> ServeTicket:
        """Admit (or shed) one request. Admission is queue-depth bounded —
        the engine's waiting queue, not the in-flight slots, is the bound:
        live decode slots drain at a fixed rate, the queue is where
        overload accumulates."""
        with self._lock:
            if len(self.engine.queue) >= self.queue_depth:
                self.telemetry.record_shed(tenant)
                return ServeTicket(None, tenant, shed=True)
            rid = self._next_rid
            self._next_rid += 1
            req = Request(rid, prompt, max_new_tokens=max_new_tokens,
                          eos_id=eos_id)
            ticket = ServeTicket(req, tenant)
            self._tickets[rid] = ticket
            self.engine.submit(req)
            self.telemetry.record_admitted(tenant)
        return ticket

    # ------------------------------------------------------------------
    def _tick_fn(self, task: JobTask, tick: int):
        """One engine tick under the serve group's lock (the program span
        ``serve.tick``, whose ``handoff_ms`` is the scheduler's hand-off
        from the tick's submission to its start). Retirement drains through
        the engine's ``retired`` list (the same channel
        ``run_to_completion`` uses), so a request admitted and finished
        within this very tick resolves its ticket here."""
        with span("serve.tick") as sp:
            self.engine.step()
            retired, self.engine.retired = self.engine.retired, []
            out = []
            with self._lock:
                for req in retired:
                    ticket = self._tickets.pop(req.rid, None)
                    if ticket is None:
                        continue
                    ticket._resolve()
                    self.completed.append(ticket)
                    self.telemetry.record_completed(ticket.tenant, ticket.latency_ms)
                    out.append(ticket)
            if sp:
                sp.args.update(tick=tick, retired=len(out),
                               handoff_ms=1e3 * (sp.t0 - task.t_submit))
        return out

    def tick_async(self) -> IFuture:
        """Schedule ONE decode tick as a job task. Ticks chain (each deps on
        the previous) and carry the serve group's lock, so they serialize
        among themselves while the scheduler interleaves them with
        ingestion micro-batches on other groups."""
        deps = [self._prev_tick] if self._prev_tick is not None else []
        task = JobTask(f"{self.name}.tick#{self._tick_no}", "serve", self.worker,
                       None, deps, group=self.group)
        task.fn = functools.partial(self._tick_fn, task, self._tick_no)
        self._tick_no += 1
        self._prev_tick = task
        if self.job is not None:
            task.tracer = self.job.tracer  # as IJob's own submissions do
            self.job.tasks.append(task)
        self.scheduler.submit(task)
        return IFuture(task)

    def drained(self) -> bool:
        return not self.engine.queue and not any(
            r is not None for r in self.engine.live)

    def run_until_drained(self, max_ticks: int = 10_000) -> list:
        """Tick (as scheduler tasks) until queue and slots drain; returns
        the tickets completed during the run."""
        start = len(self.completed)
        ticks = 0
        while not self.drained() and ticks < max_ticks:
            self.tick_async().result()
            ticks += 1
        return self.completed[start:]

    def stats(self) -> dict:
        return {
            "ticks": self._tick_no,
            "completed": len(self.completed),
            "waiting": len(self.engine.queue),
            "live": sum(r is not None for r in self.engine.live),
            "telemetry": self.telemetry.snapshot(),
        }
