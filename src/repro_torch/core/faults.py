"""Deterministic fault injection (docs/fault_tolerance.md, DESIGN.md §9).

The paper's recovery claims (§3.5, Fig. 3 — "the scheduler resubmits failed
tasks using the lineage DAG") are only testable if failures can be produced
*on demand, deterministically, at every task kind*. This module is that
layer: a ``FaultPlan`` is a replayable list of rules ("kill block 2 of the
map node on its first attempt", "fail the sort collective once", "delay
this task 1 s"), and the runtime calls ``faults.check(site, **info)`` at
every injection site. With no active plan the check is a single global
read — the production hot path pays one ``is None`` test.

Injection sites (threaded through the runtime):

  ==================  =====================================================
  site                where / info keys
  ==================  =====================================================
  ``dag.block``       per-block narrow/fused evaluation (``dag.py``):
                      ``op``, ``block``, ``fused``
  ``dag.node``        whole-node (wide / native) evaluation: ``op``
  ``dag.repair``      lineage repair of a lost cached block: ``op``,
                      ``block``
  ``shuffle.stage``   a wide collective stage (``shuffle_plan.py``):
                      ``kind`` (sort/distinct/reduceByKey/groupByKey/
                      partitionBy/join), ``p``
  ``shuffle.overflow``the capacity-overflow retry path: ``kind``
  ``kernel.stage``    a KERNEL-BACKED wide stage (``shuffle_plan.py``,
                      docs/kernels.md) — fires only when the stage runs on
                      the kernel tier: ``kind``, ``kernel``
                      (segment_reduce/bucket_route), ``p``. A task fault:
                      the scheduler retries via lineage.
  ``kernel.capability``the kernel tier's per-node capability check
                      (``kernels/registry.py``): ``kernel``. NOT a task
                      fault — an injected failure degrades the node to the
                      plain-torch fallback without erroring.
  ``job.task``        one scheduler attempt of a job task (``job.py``):
                      ``name``, ``kind``, ``attempt``
  ``reshard``         communicator edges (``cluster.py`` importData /
                      native args, ``job.py`` inter-group edges): ``kind``
  ``comm.handle``     awaiting a still-pending nonblocking collective
                      (``comm.py`` ``CollHandle.wait``, and the scheduler's
                      end-of-task drain of never-awaited handles): ``coll``
                      (allreduce/gather/alltoall/…), ``phase`` (``wait`` /
                      ``flush``)
  ``stream.batch``    one micro-batch task of a streaming pump
                      (``streaming/context.py``, docs/streaming.md):
                      ``tenant``, ``batch``. A task fault: the scheduler
                      retries via lineage and the pump counts the replay
                      (``batches_replayed``) — output stays bit-identical.
  ``stream.admit``    an admission decision (``streaming/admission.py``):
                      ``tenant``. NOT a task fault — an injected failure
                      forces a ``shed`` decision (counted, never retried).
  ``elastic.reshard`` one incremental block move during a mesh resize
                      (``distributed/elastic.py`` ``reshard_cached``,
                      docs/elasticity.md): ``op``, ``block``. NOT retried in
                      place — an injected failure models the block lost in
                      flight: it becomes a lineage hole (counted as an
                      elastic ``reshard_recompute``) and the next action
                      repairs it block-wise, exactly like an executor kill.
  ==================  =====================================================

Rules match a site plus a subset of the info keys; string values match via
``fnmatch`` (exact unless the pattern carries ``*``/``?``), everything else
by equality. Each rule keeps its own match counter, so ``attempt=k`` means
"the k-th time this exact site+match fires" — replayable across runs.
Every firing is appended to ``plan.log`` for post-hoc assertions.

``Recoverable`` is the error contract with the scheduler: a job task
failing with a ``Recoverable`` error (``FaultInjected``, or anything a
deployment maps onto it — executor loss, preempted containers) is retried
via lineage up to ``ignis.task.attempts``; any other exception is an
application error and cascades (core/job.py).
"""
from __future__ import annotations

import contextlib
import random
import threading
import time
from dataclasses import dataclass
from typing import Optional


class Recoverable(Exception):
    """Base class for errors the job scheduler may retry via lineage."""


class FaultInjected(Recoverable):
    """Raised by an injection site when a fail rule fires."""


def recoverable(error: BaseException) -> bool:
    """Scheduler retry policy: injected/infrastructure faults retry,
    deterministic application errors cascade."""
    return isinstance(error, Recoverable)


@dataclass
class _Rule:
    site: str
    match: dict
    action: str  # "fail" | "delay"
    attempt: Optional[int] = 0  # None → any attempt (bounded by times)
    times: Optional[int] = None  # None → unbounded firings
    seconds: float = 0.0
    count: int = 0  # matching check() calls seen
    fired: int = 0  # faults actually injected
    note: str = ""

    def matches(self, site: str, info: dict) -> bool:
        if site != self.site:
            return False
        from fnmatch import fnmatch

        for k, v in self.match.items():
            if k not in info:
                return False
            got = info[k]
            if isinstance(v, str):
                if not fnmatch(str(got), v):
                    return False
            elif got != v:
                return False
        return True


class FaultPlan:
    """A deterministic, seedable set of fault-injection rules.

    The ``seed`` drives ``choice``/``randint`` — used by chaos/property
    tests to *sample* kill-points reproducibly; rule firing itself is
    purely counter-based and independent of the seed.
    """

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)
        self.rules: list[_Rule] = []
        self.log: list[tuple] = []  # (site, action, info) per firing
        self._lock = threading.Lock()

    # ---- registration --------------------------------------------------
    def fail(self, site: str, attempt: Optional[int] = 0,
             times: Optional[int] = None, note: str = "", **match) -> "FaultPlan":
        self.rules.append(_Rule(site, match, "fail", attempt, times, note=note))
        return self

    def delay(self, site: str, seconds: float, attempt: Optional[int] = 0,
              times: Optional[int] = None, note: str = "", **match) -> "FaultPlan":
        self.rules.append(
            _Rule(site, match, "delay", attempt, times, seconds=seconds, note=note))
        return self

    # sugar for the common kill-points ------------------------------------
    def kill_block(self, op: str, block: int, attempt: int = 0) -> "FaultPlan":
        """Fail evaluation of block ``block`` of node ``op`` on attempt k."""
        return self.fail("dag.block", op=op, block=block, attempt=attempt)

    def fail_node(self, op: str, attempt: int = 0) -> "FaultPlan":
        """Fail a whole-node (wide / native) evaluation on attempt k."""
        return self.fail("dag.node", op=op, attempt=attempt)

    def fail_collective(self, kind: str, times: int = 1) -> "FaultPlan":
        """Fail the next ``times`` runs of a shuffle collective stage."""
        return self.fail("shuffle.stage", kind=kind, attempt=None, times=times)

    def fail_task(self, name: str, attempt: int = 0) -> "FaultPlan":
        """Fail a job task by (fnmatch) name on scheduler attempt k."""
        return self.fail("job.task", name=name, attempt=attempt)

    def fail_kernel_stage(self, kind: str = "*", times: int = 1) -> "FaultPlan":
        """Kill the next ``times`` kernel-backed wide stages (lineage retry)."""
        return self.fail("kernel.stage", kind=kind, attempt=None, times=times)

    def fail_kernel_capability(self, kernel: str = "*",
                               times: Optional[int] = None) -> "FaultPlan":
        """Fail kernel capability checks: the node degrades to the
        plain-torch fallback (no error, no retry)."""
        return self.fail("kernel.capability", kernel=kernel, attempt=None,
                         times=times)

    def fail_stream_batch(self, tenant: str = "*", batch=None,
                          attempt: int = 0,
                          times: Optional[int] = None) -> "FaultPlan":
        """Kill a streaming micro-batch task on scheduler attempt k: the
        scheduler replays it via lineage; the pump's commit stays in order
        and counts the replay exactly (docs/streaming.md)."""
        match = {"tenant": tenant}
        if batch is not None:
            match["batch"] = batch
        return self.fail("stream.batch", attempt=attempt, times=times, **match)

    def fail_stream_admit(self, tenant: str = "*", times: int = 1) -> "FaultPlan":
        """Force the next ``times`` admission decisions for ``tenant`` to
        shed — overload as a policy outcome, not an error (no retry)."""
        return self.fail("stream.admit", tenant=tenant, attempt=None,
                         times=times)

    def fail_elastic_reshard(self, op: str = "*", block=None,
                             times: Optional[int] = 1) -> "FaultPlan":
        """Lose a cached block mid-move during a mesh resize: the resize
        completes, the block becomes a lineage hole, and the next action
        repairs it block-wise (docs/elasticity.md — no task retry here)."""
        match = {"op": op}
        if block is not None:
            match["block"] = block
        return self.fail("elastic.reshard", attempt=None, times=times, **match)

    def delay_task(self, name: str, seconds: float, attempt: int = 0) -> "FaultPlan":
        """Straggle a job task: sleep before its k-th scheduler attempt."""
        return self.delay("job.task", seconds, name=name, attempt=attempt)

    def delay_block(self, op: str, block: int, seconds: float,
                    attempt: int = 0) -> "FaultPlan":
        """Straggle one block evaluation (speculative-execution trigger)."""
        return self.delay("dag.block", seconds, op=op, block=block, attempt=attempt)

    def fail_reshard(self, kind: str = "*", attempt: int = 0) -> "FaultPlan":
        """Fail a communicator edge (importData / native / group)."""
        return self.fail("reshard", kind=kind, attempt=attempt)

    def kill_handle(self, coll: str = "*", attempt: int = 0,
                    phase: str = "*") -> "FaultPlan":
        """Kill a pending nonblocking collective as it is awaited: the k-th
        wait (or end-of-task ``flush``) of a matching in-flight handle fails
        as if the transfer was lost mid-flight."""
        return self.fail("comm.handle", coll=coll, phase=phase, attempt=attempt)

    # ---- deterministic sampling ----------------------------------------
    def choice(self, seq):
        return self.rng.choice(list(seq))

    def randint(self, a: int, b: int) -> int:
        return self.rng.randint(a, b)

    # ---- the runtime hook ----------------------------------------------
    def check(self, site: str, **info):
        fire = None
        with self._lock:
            # every matching rule counts this check (so "attempt k" always
            # means the k-th evaluation of the kill-point, even when another
            # rule fired earlier attempts); at most one rule fires per check
            for rule in self.rules:
                if not rule.matches(site, info):
                    continue
                n = rule.count
                rule.count += 1
                if fire is not None:
                    continue
                if rule.attempt is not None and n != rule.attempt:
                    continue
                if rule.times is not None and rule.fired >= rule.times:
                    continue
                rule.fired += 1
                self.log.append((site, rule.action, dict(info)))
                fire = rule
        if fire is None:
            return
        if fire.action == "delay":
            time.sleep(fire.seconds)
            return
        raise FaultInjected(f"injected fault at {site} ({info})")

    def injections(self, site: Optional[str] = None) -> int:
        """How many faults actually fired (optionally for one site)."""
        with self._lock:
            return sum(1 for s, _a, _i in self.log if site is None or s == site)


# ---------------------------------------------------------------------------
# active-plan plumbing: one process-wide plan, visible from every thread
# (job tasks run on pool threads; a thread-local would hide the plan from
# the scheduler). Chaos tests are serialized, so a single slot suffices.
# ---------------------------------------------------------------------------
_active: Optional[FaultPlan] = None


def active() -> Optional[FaultPlan]:
    return _active


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """Install ``plan`` as the process-wide fault plan for the block."""
    global _active
    prev = _active
    _active = plan
    try:
        yield plan
    finally:
        _active = prev


def check(site: str, **info):
    """Injection-site hook. No-op (one global read) without an active plan."""
    plan = _active
    if plan is not None:
        plan.check(site, **info)
