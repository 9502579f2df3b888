"""Lazy job-oriented driver layer: IJob / IFuture / JobScheduler.

The paper's job hierarchy (§3.2, Figs. 2–3) holds dataflow tasks, native
SPMD tasks and inter-worker transfers in ONE task DAG; this module is the
driver-side realisation. An ``IJob`` partitions a frame's lineage into
uniform *job tasks* at cross-worker boundaries:

  * a **stage** task materialises a subgraph on the worker that owns it,
  * a **native** task runs a ``worker.call`` / ``void_call`` app node,
  * a **reshard** task executes an ``importData`` node (the inter-worker
    communicator, paper Fig. 4),
  * an **action** task applies the driver-side action function to the
    materialised blocks.

Tasks execute on a shared thread pool under per-worker locks, so a worker's
engine is never entered concurrently while *independent branches on
different workers overlap* — the Pilot-style async-handle model (PAPERS.md:
Luckow et al. 2015) over IgnisHPC's hierarchy. Results flow between tasks
through the job's shared memo (the same memo ``DagEngine.evaluate`` uses),
so a downstream worker never re-evaluates an upstream worker's subgraph.

Every ``IDataFrame`` action has an ``*_async`` twin returning an
``IFuture``; the eager form is a facade — ``df.count()`` is literally
``df.count_async().result()`` (docs/driver.md).
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Optional

from repro_torch.core import comm, faults
from repro_torch.core.dag import _OverlayMemo
from repro_torch.core.metrics import Counters, MetricsTree, warn_deprecated
from repro_torch.profile import spans

_task_ids = itertools.count()


def task_history_key(task) -> tuple:
    """The cost-model history key for a task — structural, so retries and
    re-submissions of the same logical work share one duration history
    (docs/profiling.md §auto). Node-backed tasks key on their node's
    signature; action tasks on the action name."""
    from repro_torch.core.dag import node_sig

    node = getattr(task, "node", None)
    if node is not None:
        return (task.kind, node_sig(node))
    return (task.kind, task.name.split("(", 1)[0])


def _run_body(task) -> Any:
    """Run ``task``'s fn with the thread's program spans (profile/spans.py)
    going to the tracer attached to its job, else to its worker's."""
    tracer = task.tracer or getattr(task.worker, "tracer", None)
    if tracer is None:
        return task.fn()
    with spans.recording(tracer.buffer):
        return task.fn()


PENDING = "pending"
RUNNING = "running"
DONE = "done"
FAILED = "failed"


class JobTask:
    """One schedulable unit of a job DAG (uniform across task kinds)."""

    __slots__ = (
        "id", "name", "kind", "worker", "fn", "deps", "dependents",
        "remaining", "state", "result", "error", "event", "callbacks",
        "cb_lock", "scheduler", "t_submit", "t_start", "t_end",
        "group", "node", "lock", "attempt", "attempts", "lock_dropped",
        # profiling (docs/profiling.md): the thread that ran the body, the
        # serialisation-lock wait that preceded it, the compute→settle
        # phase boundary timestamps, and the job's tracer (if attached)
        "tid", "t_lock_wait", "t_compute_end", "t_settle_end", "tracer",
    )

    def __init__(self, name: str, kind: str, worker, fn: Callable[[], Any],
                 deps: list["JobTask"], group=None, node=None,
                 attempts: int | None = None):
        self.id = next(_task_ids)
        self.name = name
        self.kind = kind  # "action" | "native" | "reshard" | "stage"
        self.worker = worker
        self.fn = fn
        self.deps = list(deps)
        self.dependents: list[JobTask] = []
        self.remaining = 0
        self.state = PENDING
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.event = threading.Event()
        self.callbacks: list[Callable] = []
        self.cb_lock = threading.Lock()  # guards callbacks vs resolution
        self.scheduler = None  # set on submit; lets futures help-while-waiting
        self.t_submit = time.perf_counter()
        self.t_start = 0.0
        self.t_end = 0.0
        self.tid = 0
        self.t_lock_wait = 0.0
        self.t_compute_end = 0.0
        self.t_settle_end = 0.0
        self.tracer = None
        # gang scheduling (docs/collectives.md): the group communicator this
        # task executes on (None → the worker's base mesh), the TaskNode it
        # materialises (for inter-group reshard edges), and the serialisation
        # lock it must hold — the worker's job lock, or the GROUP's lock so
        # tasks on disjoint sub-meshes of one worker run concurrently.
        self.group = group
        self.node = node
        # fault tolerance (docs/fault_tolerance.md): total execution attempts
        # for this task. A task failing with a faults.Recoverable error is
        # re-run by the scheduler — through the job's shared memo, so only
        # the failed subgraph recomputes (lineage repair at task granularity)
        # — until it succeeds or exhausts the budget; non-recoverable errors
        # cascade immediately. ``None`` → read ``ignis.task.attempts`` from
        # the owning worker's properties (1 for worker-less tasks).
        if attempts is None:
            props = getattr(getattr(worker, "cluster", None), "props", None)
            attempts = props.get_int("ignis.task.attempts", 1) if props else 1
        self.attempt = 0
        self.attempts = max(1, int(attempts))
        # set by JobScheduler._settle when the runner hands the task's lock
        # off early (awaiting a nonblocking collective with no more
        # lock-protected work left); the acquiring frame then skips its
        # paired release
        self.lock_dropped = False
        if worker is None:
            self.lock = None
        elif group is not None and hasattr(worker, "group_lock"):
            self.lock = worker.group_lock(group)
        else:
            self.lock = getattr(worker, "_job_lock", None)

    @property
    def duration_ms(self) -> float:
        return (self.t_end - self.t_start) * 1e3 if self.t_end else 0.0


class IFuture:
    """Async handle for a submitted job task (the paper-adjacent
    Pilot-abstraction handle): ``result()`` blocks until the scheduler
    resolves the task, propagating any executor exception."""

    def __init__(self, task: JobTask):
        self._task = task

    @property
    def task(self) -> JobTask:
        return self._task

    def done(self) -> bool:
        return self._task.state in (DONE, FAILED)

    def running(self) -> bool:
        return self._task.state == RUNNING

    def _wait(self, timeout: float | None):
        task = self._task
        sched = task.scheduler
        held = () if sched is None else getattr(sched._local, "held_locks", ())
        if not held:
            if not task.event.wait(timeout):
                raise TimeoutError(f"task {task.name!r} still {task.state}")
            return
        # Called from inside a running task while holding job locks:
        # parking here could deadlock (a task that needs one of OUR locks
        # can never run on the pool). Cooperative wait instead — execute
        # claimable tasks guarded by locks this thread holds.
        deadline = None if timeout is None else time.perf_counter() + timeout
        delay = 0.002  # back off once the help queue is drained
        while not task.event.wait(delay):
            while sched._help(held) and not task.event.is_set():
                delay = 0.002
            delay = min(delay * 2, 0.05)
            if deadline is not None and time.perf_counter() >= deadline:
                raise TimeoutError(f"task {task.name!r} still {task.state}")

    def result(self, timeout: float | None = None):
        self._wait(timeout)
        if self._task.state == FAILED:
            raise self._task.error
        return self._task.result

    def exception(self, timeout: float | None = None) -> Optional[BaseException]:
        self._wait(timeout)
        return self._task.error

    def add_done_callback(self, fn: Callable[[JobTask], None]):
        """Run ``fn(task)`` when the task resolves (immediately if it has).
        Registration is synchronized with resolution (the event is set and
        the callback list drained under the task's cb_lock), so a callback
        can neither be lost nor fired twice."""
        task = self._task
        with task.cb_lock:
            if not task.event.is_set():
                task.callbacks.append(fn)
                return
        fn(task)


class JobScheduler:
    """Topological executor for job tasks across workers.

    Ready tasks (all deps resolved) run on a shared thread pool; each task
    acquires its serialisation lock — the owning worker's re-entrant job
    lock, or, for a gang-scheduled task, the lock of its GROUP communicator
    (docs/collectives.md) — so two tasks holding the SAME lock never run
    concurrently, while independent branches on different workers and on
    disjoint sub-meshes of the same worker overlap. The worker lock does
    not exclude group locks: an ungrouped (world-mesh) task may run
    alongside gang tasks of the same worker — correct (engine caches are
    locked, placement is re-established per stage) but oversubscribed, so
    keep a worker's concurrent jobs all-grouped for strict slice
    isolation. Failure is recovered before it cascades: a task failing
    with a ``faults.Recoverable`` error is re-run through the job's shared
    memo (lineage repair at task granularity) up to its
    ``ignis.task.attempts`` budget; only a non-recoverable error, or an
    exhausted budget, cascades — dependents then fail with the same error
    without running (docs/fault_tolerance.md).
    """

    def __init__(self, max_threads: int = 16):
        self.max_threads = max_threads
        self._pool = None
        self._lock = threading.Lock()
        self._local = threading.local()
        self._running = 0
        # ready tasks handed to the pool but not yet claimed — a blocked
        # lock-holder (cooperative wait in IFuture.result) may claim and run
        # one guarded by a lock it holds
        self._claimable: list[JobTask] = []
        self.stats = Counters("scheduler", {
            "jobs_submitted": 0,
            "tasks_submitted": 0,
            "tasks_completed": 0,
            "tasks_failed": 0,
            "inline_runs": 0,
            "helped_runs": 0,
            "max_concurrent": 0,
            "gang_tasks": 0,       # tasks run on a group communicator
            "group_reshards": 0,   # inter-group reshard edges executed
            "task_retries": 0,     # recoverable-failure re-runs (faults.py)
            "coll_awaits": 0,      # handle-valued task results awaited here
            "coll_flushed": 0,     # never-awaited handles drained at task end
        })

    # ------------------------------------------------------------------
    def queue_depth(self) -> int:
        """Submitted-but-unresolved task count."""
        with self._lock:
            return (self.stats["tasks_submitted"]
                    - self.stats["tasks_completed"]
                    - self.stats["tasks_failed"])

    # ------------------------------------------------------------------
    def _ensure_pool(self):
        with self._lock:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(
                    max_workers=self.max_threads, thread_name_prefix="ignis-job"
                )
            return self._pool

    def submit(self, task: JobTask) -> JobTask:
        """Register a task; launches immediately when its deps are resolved."""
        launch = failed_dep = None
        task.scheduler = self
        with self._lock:
            self.stats["tasks_submitted"] += 1
            for d in task.deps:
                if d.state == FAILED:
                    failed_dep = d
                elif d.state != DONE:
                    d.dependents.append(task)
                    task.remaining += 1
            if failed_dep is None and task.remaining == 0:
                launch = task
        if failed_dep is not None:
            self._fail(task, failed_dep.error)
        elif launch is not None:
            self._launch(launch)
        return task

    def _launch(self, task: JobTask):
        # A nested submission from inside a running task (a native app
        # invoking an eager action) executes inline ONLY when this thread
        # already holds the task's serialisation lock — same-lock
        # reentrancy must stay on this thread, while a task guarded by a
        # foreign lock goes to the pool (acquiring a second job lock while
        # holding one is the AB/BA deadlock shape). Ready dependents of a
        # finished task also go to the pool: fan-out must not serialize on
        # the finishing thread.
        held = getattr(self._local, "held_locks", ())
        if task.lock is not None and any(task.lock is l for l in held):
            with self._lock:
                self.stats["inline_runs"] += 1
            self._run(task)
        else:
            with self._lock:
                self._claimable.append(task)
            self._ensure_pool().submit(self._run, task)

    def _help(self, held) -> bool:
        """Claim and run ONE ready task from a cooperative wait. Preference:
        a task guarded by a lock in ``held`` (this thread already holds it
        — re-entrant, always safe). Failing that, any ready task whose
        lock can be TRY-acquired: non-blocking acquisition adds no
        wait-for edge, so it cannot create a deadlock cycle, and it keeps
        the DAG draining even when every pool thread is parked (pool
        exhaustion under deeply nested cross-worker calls). Returns True if
        a task ran. A pool thread that also picked the task up blocks on
        the task lock, then finds it claimed (state != PENDING) and backs
        off — no double run, and the backed-off frame always releases its
        own acquire (see the per-frame release contract in _run)."""
        cand = foreign = None
        with self._lock:
            for t in self._claimable:
                if t.state != PENDING or t.lock is None:
                    continue
                if any(t.lock is l for l in held):
                    cand = t
                    break
                if foreign is None:
                    foreign = t
            if cand is not None:
                self.stats["helped_runs"] += 1
        if cand is not None:
            self._run(cand)  # held lock: re-entrant acquire, cannot block
            return True
        if foreign is not None:
            lock = foreign.lock
            if lock is None or lock.acquire(blocking=False):
                claimed: list = []
                try:
                    with self._lock:
                        self.stats["helped_runs"] += 1
                    self._run_locked(foreign, claimed)
                finally:
                    if lock is not None and not (claimed and foreign.lock_dropped):
                        lock.release()
                return True
        return False

    def _run(self, task: JobTask):
        # Acquire the task lock BEFORE claiming: a cooperative waiter that
        # already holds the lock can claim the task while a pool thread is
        # still parked on acquire; the late acquirer sees state != PENDING
        # and backs off. The release-skip is PER-FRAME, not per-task:
        # ``task.lock_dropped`` describes the one frame that claimed and ran
        # the task body (the only frame that can reach _settle's drop), so
        # the paired release is skipped only when THIS frame is that frame
        # (``claimed`` non-empty). A frame that parked on acquire, won the
        # lock after the claiming helper dropped it, and backed off on
        # state != PENDING must release its own acquisition — an RLock
        # cannot be released from any other thread, so skipping here would
        # leak the worker/group lock forever.
        lock = task.lock
        lock_wait = 0.0
        if lock is not None:
            t0 = time.perf_counter()
            lock.acquire()
            lock_wait = time.perf_counter() - t0
        claimed: list = []
        try:
            self._run_locked(task, claimed, lock_wait=lock_wait)
        finally:
            if lock is not None and not (claimed and task.lock_dropped):
                lock.release()

    def _unclaim_locked(self, task: JobTask):
        """Drop a task leaving PENDING from the claimable list (caller holds
        self._lock) — entries must not outlive their tasks, or the scheduler
        would pin every job's closures and results for the process lifetime."""
        for i, t in enumerate(self._claimable):
            if t is task:
                del self._claimable[i]
                return

    def _settle(self, task, result, pending, held):
        """Complete a task's nonblocking collectives: await a handle-valued
        result, then flush every handle the task created but never awaited
        (the never-awaited-at-job-end rule — docs/fault_tolerance.md).

        The award of the nonblocking design happens here: when this thread
        holds the task's serialisation lock only for THIS task (not
        re-entrantly from an outer frame), the lock is DROPPED for good
        before the await — the task's own mutations are complete, only
        in-flight device work remains — so the next task on the same
        worker/group starts its tracing and planning while this one's
        collectives drain. The drop is one-way: re-acquiring here could
        deadlock against a peer that took the lock and is now parked on
        THIS task's event (IFuture's cooperative wait holds its locks).
        ``task.lock_dropped`` tells the CLAIMING frame (_run/_help, the one
        whose ``_run_locked`` call ran the body — see ``claimed``) to skip
        its paired release; any other frame that acquired the lock and
        backed off still releases its own acquisition. A retry after a
        fault injected at the ``comm.handle`` site re-runs the fn
        unlocked — a group slice
        briefly oversubscribed is explicitly tolerated (cluster.group_lock),
        never corrupted, since every task binds its own communicator."""
        if not (comm.is_handle(result) or pending):
            return result
        lock = task.lock
        drop = (lock is not None and not task.lock_dropped
                and not any(lock is l for l in held))
        if drop:
            task.lock_dropped = True
            lock.release()
        if comm.is_handle(result):
            result = result.wait()
            with self._lock:
                self.stats["coll_awaits"] += 1
        flushed = 0
        while pending:
            pending[-1].wait(_phase="flush")  # deregisters from the scope
            flushed += 1
        if flushed:
            with self._lock:
                self.stats["coll_flushed"] += flushed
        return result

    def _run_locked(self, task: JobTask, claimed: Optional[list] = None,
                    lock_wait: float = 0.0):
        with self._lock:
            if task.state != PENDING:  # cascaded failure or claimed elsewhere
                return  # back-off: the caller's finally releases its acquire
            task.state = RUNNING
            if claimed is not None:
                # tell the calling frame it is the claiming frame — only then
                # may it honour task.lock_dropped and skip its release
                claimed.append(task)
            self._unclaim_locked(task)
            self._running += 1
            self.stats["max_concurrent"] = max(
                self.stats["max_concurrent"], self._running
            )
        task.t_start = time.perf_counter()
        task.t_lock_wait = lock_wait
        task.tid = threading.get_ident()
        held = getattr(self._local, "held_locks", ())
        error = None
        try:
            self._local.held_locks = held + (task.lock,)
            try:
                worker = task.worker
                if task.group is not None and worker is not None:
                    with self._lock:
                        self.stats["gang_tasks"] += 1
                # Retry loop (paper §3.5: "resubmits failed tasks using the
                # lineage DAG"): a recoverable failure re-runs the task fn.
                # Deps already materialised sit in the job's shared memo, so
                # the retry recomputes only this task's own subgraph; cached
                # nodes that lost blocks repair block-wise inside the engine.
                while True:
                    try:
                        faults.check("job.task", name=task.name, kind=task.kind,
                                     attempt=task.attempt)
                        # the runner (not the task fn) binds the communicator:
                        # a cooperative helper thread may carry another task's
                        # group binding, so every task re-binds its own
                        # (None → base mesh)
                        if worker is not None and hasattr(worker, "use_group"):
                            with worker.use_group(task.group):
                                with comm.track() as pending:
                                    task.result = _run_body(task)
                        else:
                            with comm.track() as pending:
                                task.result = _run_body(task)
                        # a task completes only when its collectives do:
                        # await a handle-valued result (MPI_Wait on the
                        # device; releases the GIL and — when safe — the
                        # task's own lock, so peer tasks keep running), then
                        # drain handles the task issued but never awaited —
                        # an in-flight collective must not outlive its task,
                        # and an injected fault on either re-enters THIS
                        # retry loop, re-running the task fn and re-issuing
                        # its collectives.
                        task.t_compute_end = time.perf_counter()
                        task.result = self._settle(task, task.result,
                                                   pending, held)
                        task.t_settle_end = time.perf_counter()
                        break
                    except BaseException as e:
                        task.attempt += 1
                        if task.attempt >= task.attempts or not faults.recoverable(e):
                            raise
                        if task.lock_dropped:
                            # the settle handed the lock off before faulting;
                            # the retry runs unlocked (see _settle), so stop
                            # advertising the lock to nested cooperative waits
                            self._local.held_locks = held
                        with self._lock:
                            self.stats["task_retries"] += 1
            finally:
                self._local.held_locks = held
        except BaseException as e:  # surfaced via IFuture.result()
            error = e
        task.t_end = time.perf_counter()
        with self._lock:
            self._running -= 1
            if error is None:
                task.state = DONE
                self.stats["tasks_completed"] += 1
            else:
                task.error = error
                task.state = FAILED
                self.stats["tasks_failed"] += 1
            task.fn = None  # never called again — release the closure (and
            # with it the job memo / blocks it pins) once the task resolves
            dependents = list(task.dependents)
        self._observe(task, error)
        self._resolve(task)
        for dep in dependents:
            self._dep_resolved(dep, task)

    def _observe(self, task: JobTask, error):
        """Feed the profiling surfaces as a task resolves: the attached
        tracer's span buffer (docs/profiling.md), and — for successful
        runs — the owning worker's cost-model task history, which is what
        ``ignis.task.speculative.timeout=auto`` derives deadlines from.
        Observation must never poison the DAG: failures are swallowed."""
        tracer = task.tracer
        if tracer is not None:
            try:
                tracer.task_done(task)
            except Exception:
                pass
        model = getattr(getattr(task.worker, "engine", None),
                        "cost_model", None)
        if (model is not None and error is None
                and (tracer is None or tracer.cost is not model)):
            try:
                model.observe_task(task_history_key(task),
                                   task.t_end - task.t_start)
            except Exception:
                pass

    def _resolve(self, task: JobTask):
        with task.cb_lock:
            task.event.set()
            callbacks, task.callbacks = task.callbacks, []
        for cb in callbacks:
            try:
                cb(task)
            except Exception:  # observer errors never poison the DAG
                pass

    def _fail(self, task: JobTask, error: BaseException):
        """Cascade an upstream failure through ``task`` and its dependents."""
        with self._lock:
            if task.state in (DONE, FAILED):
                return
            task.error = error
            task.state = FAILED
            self._unclaim_locked(task)
            task.fn = None
            self.stats["tasks_failed"] += 1
            dependents = list(task.dependents)
        self._resolve(task)
        for dep in dependents:
            self._fail(dep, error)

    def _dep_resolved(self, task: JobTask, dep: JobTask):
        if dep.state == FAILED:
            self._fail(task, dep.error)
            return
        launch = False
        with self._lock:
            task.remaining -= 1
            launch = task.remaining == 0 and task.state == PENDING
        if launch:
            self._launch(task)


class _TaskMemo(_OverlayMemo):
    """Task-local view of a job's shared evaluation memo: resharded copies
    of cross-group dep results live in this dict (reads prefer them, so the
    consumer's engine sees blocks on ITS communicator), while — unlike the
    read-only-base ``_OverlayMemo`` it extends — every new materialisation
    writes through to the shared memo for downstream reuse. The shared memo
    itself is never re-placed — see ``IJob._task_memo``."""

    __slots__ = ()

    def __init__(self, shared: dict, overlay: dict):
        super().__init__(shared)
        dict.update(self, overlay)  # seed locally, never write through

    def __setitem__(self, key, value):
        dict.__setitem__(self, key, value)
        self._base[key] = value


_default: Optional[JobScheduler] = None
_default_lock = threading.Lock()


def default_scheduler() -> JobScheduler:
    """The process-wide scheduler every implicit (eager-facade) job uses."""
    global _default
    with _default_lock:
        if _default is None:
            _default = JobScheduler()
    return _default


class IJob:
    """A named group of driver submissions scheduled as one DAG.

    ``submit_action`` walks the frame's lineage, cuts it at *task
    boundaries* — native app nodes, ``importData`` reshards, and any edge
    crossing worker ownership — and submits one job task per boundary node
    plus the action task itself. Tasks share ``self.memo`` (the DagEngine
    evaluation memo), so each subgraph is evaluated exactly once, by the
    worker that owns it, and downstream tasks pick results out of the memo.

    An ``IJob`` may span many frames, workers and actions; futures resolve
    independently (out of submission order when the DAG allows).

    Gang scheduling (docs/collectives.md): ``group=`` pins EVERY task of
    the job onto one communicator group (a per-job sub-cluster — two such
    jobs on disjoint groups run concurrently on different slices of the
    mesh); ``gang=n`` instead splits each owning worker's mesh ``n`` ways
    and deals successive submissions onto the groups round-robin. A task
    consuming blocks that a different group produced gets an inter-group
    reshard edge: the blocks are device_put sub-mesh → sub-mesh before the
    consumer runs.
    """

    def __init__(self, name: str = "job", scheduler: JobScheduler | None = None,
                 group=None, gang: int | None = None):
        self.name = name
        self.scheduler = scheduler or default_scheduler()
        self.group = group
        self.gang = gang
        self._rr = 0  # round-robin dealer for gang=n
        self.tasks: list[JobTask] = []
        self.futures: list[IFuture] = []
        self.memo: dict = {}  # TaskNode -> list[Block], shared across tasks
        self._node_tasks: dict = {}  # TaskNode -> JobTask
        # streaming telemetry hook (docs/streaming.md): StreamTelemetry
        # .attach(job) installs a snapshot thunk here; stats() surfaces it
        self.stream: Optional[Callable[[], dict]] = None
        # profiling hook (docs/profiling.md): JobTracer.attach(job) installs
        # itself here; metrics()["profile"] and trace export read it
        self.tracer = None
        self._t0 = time.perf_counter()
        with self.scheduler._lock:
            self.scheduler.stats["jobs_submitted"] += 1

    # ---- lineage → job-task planning ----------------------------------
    @staticmethod
    def _task_kind(node) -> str:
        if getattr(node, "task_kind", "dataflow") == "native":
            return "native"
        if node.op == "importData":
            return "reshard"
        return "stage"

    @staticmethod
    def _materialised(node) -> bool:
        """Hole-free result: evaluation will short-circuit here, so planning
        must neither schedule it nor descend past it. A cached node that
        lost blocks (``kill_block``) is NOT materialised — its owner must
        repair it under its own job lock."""
        return node.result is not None and not any(b is None for b in node.result)

    @classmethod
    def _is_boundary(cls, node, consumer) -> bool:
        """A parent node that must become its own job task."""
        if cls._materialised(node):
            return False
        if getattr(node, "task_kind", "dataflow") == "native":
            return True
        if node.op == "importData":
            return True
        po, co = getattr(node, "owner", None), getattr(consumer, "owner", None)
        return po is not None and co is not None and po is not co

    def _dep_tasks(self, root, group=None) -> list[JobTask]:
        """Job tasks for every boundary node reachable from ``root`` without
        crossing another boundary (those become the boundary task's deps).
        Traversal stops at materialised nodes: evaluation never descends
        below them, so ancestors (including native apps with side effects)
        must not be scheduled or re-executed. ``group`` is the submitting
        branch's communicator — threaded as a parameter, not instance
        state, so concurrent submissions into one job cannot mis-pin each
        other's boundary tasks."""
        deps, stack, seen = [], [root], {root}
        while stack:
            n = stack.pop()
            for p in n.parents:
                if p in seen:
                    continue
                seen.add(p)
                if self._materialised(p):
                    continue
                if self._is_boundary(p, n):
                    deps.append(self._node_task(p, group))
                else:
                    stack.append(p)
        return deps

    def _task_memo(self, task: JobTask) -> dict:
        """The evaluation memo for one task, with inter-group reshard edges
        applied: any dep that ran on a DIFFERENT communicator leaves its
        blocks committed to that sub-mesh; device_put copies onto this
        task's communicator (the worker's base mesh for ungrouped tasks)
        live in a task-LOCAL overlay, never the shared memo — two groups
        consuming one producer must not race each other's placements (each
        would otherwise read blocks mid-flight on the other's slice). New
        materialisations still write through to the shared memo.

        Caveat: a ``cache()``d dep short-circuits on ``node.result`` inside
        the engine BEFORE the memo, bypassing the overlay — its consumers
        read the blocks where they were cached (wide stages still re-place
        them via the shuffle manager's ingress; narrow stages follow the
        cached placement). Cross-group sharing of explicitly cached frames
        trades slice isolation for the cache hit."""
        worker = task.worker
        if worker is None or not hasattr(worker, "_base_context"):
            return self.memo
        from repro_torch.core.partition import place_block

        tgt = task.group if task.group is not None else worker._base_context
        overlay: dict = {}
        moved = 0
        for d in task.deps:
            if d.node is None or d.group is task.group:
                continue
            blocks = self.memo.get(d.node)
            if not blocks:
                continue
            faults.check("reshard", kind="group", op=d.node.op)
            overlay[d.node] = [place_block(b, tgt) for b in blocks]
            moved += len(blocks)
        if not overlay:
            return self.memo
        with self.scheduler._lock:
            self.scheduler.stats["group_reshards"] += moved
        return _TaskMemo(self.memo, overlay)

    @staticmethod
    def _evaluator(worker, task):
        """How a task materialises a node on its worker's engine: plain
        evaluation, or — for gang tasks when ``ignis.task.speculative`` is
        set — deadline-triggered speculative duplication, the straggler
        half of the paper's §3.5 recovery path (docs/fault_tolerance.md)."""
        props = getattr(getattr(worker, "cluster", None), "props", None)
        if (task.group is not None and props is not None
                and props.get_bool("ignis.task.speculative", False)):
            raw = str(props.get("ignis.task.speculative.timeout", "30")).strip()
            if raw.lower() == "auto":
                # cost-derived deadline (docs/profiling.md §auto): factor x
                # the typical observed duration of tasks with this task's
                # structural signature, read at run time so the history the
                # job has already accumulated informs its later tasks
                factor = props.get_float("ignis.task.speculative.factor", 3.0)

                def timeout_s(_t=task, _w=worker, _f=factor):
                    model = getattr(_w.engine, "cost_model", None)
                    if model is None:
                        return 30.0
                    return model.speculative_timeout_s(
                        task_history_key(_t), factor=_f, default_s=30.0)
            else:
                fixed = props.get_float("ignis.task.speculative.timeout", 30.0)
                timeout_s = lambda _fixed=fixed: _fixed
            # every speculative attempt runs on its own thread, so each must
            # re-bind the gang communicator (thread-locals don't cross spawns)
            return lambda node, memo: worker.engine.evaluate_speculative(
                node, timeout_s=timeout_s(), memo=memo,
                bind=lambda: worker.use_group(task.group))
        return lambda node, memo: worker.engine.evaluate(node, memo=memo)

    def _node_task(self, node, group=None) -> JobTask:
        """The (deduplicated) job task materialising ``node`` on its owner.
        A node shared by two branches keeps the group of whichever branch
        created its task first; later consumers in other groups get an
        inter-group reshard edge instead."""
        t = self._node_tasks.get(node)
        if t is not None:
            return t
        worker = getattr(node, "owner", None)
        deps = self._dep_tasks(node, group)
        t = JobTask(f"{node.op}#{node.id}", self._task_kind(node), worker, None,
                    deps, group=group, node=node)

        def fn(_node=node, _worker=worker, _t=t):
            return self._evaluator(_worker, _t)(_node, self._task_memo(_t))

        t.fn = fn
        t.tracer = self.tracer
        self._node_tasks[node] = t
        self.tasks.append(t)
        self.scheduler.submit(t)
        return t

    # ---- submission ----------------------------------------------------
    def _next_group(self, worker, group):
        """The communicator for this submission: explicit ``group=`` wins,
        then the job-wide group, then the gang round-robin dealer, then the
        DRIVER thread's own ``use_group`` binding — an action submitted
        inside ``with worker.use_group(g):`` must execute on ``g`` even
        though it runs on a pool thread, not the driver thread."""
        if group is not None:
            return group
        if self.group is not None:
            return self.group
        if self.gang and worker is not None and hasattr(worker, "groups"):
            gs = worker.groups(self.gang)
            g = gs[self._rr % len(gs)]
            self._rr += 1
            return g
        if worker is not None and hasattr(worker, "_ctx_local"):
            return getattr(worker._ctx_local, "ctx", None)
        return None

    def submit_action(self, frame, name: str, blocks_fn=None, task_fn=None,
                      group=None) -> IFuture:
        """Schedule an action over ``frame``'s lineage; returns its future.

        ``blocks_fn(blocks)`` maps the materialised root blocks to the
        action result; alternatively ``task_fn(memo)`` takes over the whole
        evaluation (early-exit actions like ``take``). ``group`` pins this
        submission (and the boundary tasks it creates) onto a communicator
        group."""
        node, worker = frame.node, frame.worker
        gsel = self._next_group(worker, group)
        if self._materialised(node):
            deps = []  # evaluation short-circuits at the root
        elif self._is_boundary(node, node):  # native/reshard root: own task
            deps = [self._node_task(node, gsel)]
        else:
            deps = self._dep_tasks(node, gsel)
        t = JobTask(f"{name}({node.op}#{node.id})", "action", worker, None, deps,
                    group=gsel)

        def fn(_t=t):
            memo = self._task_memo(_t)
            if task_fn is not None:
                return task_fn(memo)
            blocks = self._evaluator(worker, _t)(node, memo)
            return blocks_fn(blocks)

        t.fn = fn
        t.tracer = self.tracer
        self.tasks.append(t)
        self.scheduler.submit(t)
        fut = IFuture(t)
        self.futures.append(fut)
        return fut

    # ---- introspection -------------------------------------------------
    def wait(self, timeout: float | None = None) -> list:
        """Resolve every submitted future, in submission order. ``timeout``
        is an overall deadline for the whole job, not per future."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        out = []
        for f in self.futures:
            left = None if deadline is None else max(0.0, deadline - time.perf_counter())
            out.append(f.result(left))
        return out

    def release(self):
        """Drop the job's evaluation memo and planning state. The shared
        memo intentionally pins every evaluated subgraph's blocks for reuse
        *within* the job; a long-lived job object should release() once its
        futures are resolved to restore the eager path's memory lifetime.
        ``persist()``-cached nodes are unaffected (they live on TaskNodes)."""
        self.memo.clear()
        self._node_tasks.clear()

    def stats(self) -> dict:
        """Deprecated facade over ``metrics()`` (docs/profiling.md):
        the flat older shape — task summary at the top level, the
        ``coll`` subtree inline, ``stream`` when attached. Key names and
        merged shapes are unchanged."""
        warn_deprecated("IJob.stats()", "IJob.metrics()")
        return {
            **self._task_summary(),
            # collective-engine telemetry (process-wide: persistent-plan
            # cache + handles; docs/collectives.md) and this scheduler's
            # handle settlement counters
            "coll": self.metrics("coll"),
            # per-tenant streaming/serving telemetry, when a StreamTelemetry
            # is attached to this job (docs/streaming.md)
            **({"stream": self.stream()} if self.stream is not None else {}),
        }

    def metrics(self, path: str | None = None) -> dict:
        """The job's namespaced metrics tree (docs/profiling.md §metrics):
        ``tasks/`` (this job's task-state summary), ``scheduler/`` (the
        owning scheduler's counters), ``coll/`` (process-wide collective
        engine + this scheduler's settlement counters — same shape as the
        ``stats()["coll"]`` facade), plus ``stream/`` and ``profile/`` when
        a StreamTelemetry or JobTracer is attached. ``path`` selects one
        subtree (``metrics("coll")``)."""
        tree = MetricsTree(
            tasks=self._task_summary,
            scheduler=self.scheduler.stats,
            coll=lambda: {**comm.comm_stats(),
                          "awaits": self.scheduler.stats["coll_awaits"],
                          "flushed": self.scheduler.stats["coll_flushed"]},
        )
        if self.stream is not None:
            tree.mount("stream", self.stream)
        if self.tracer is not None:
            tree.mount("profile", self.tracer.summary)
        return tree.snapshot(path)

    def _task_summary(self) -> dict:
        by_state: dict[str, int] = {}
        for t in self.tasks:
            by_state[t.state] = by_state.get(t.state, 0) + 1
        return {
            "tasks": len(self.tasks),
            "actions": sum(1 for t in self.tasks if t.kind == "action"),
            "serve": sum(1 for t in self.tasks if t.kind == "serve"),
            "native": sum(1 for t in self.tasks if t.kind == "native"),
            "reshard": sum(1 for t in self.tasks if t.kind == "reshard"),
            "stage": sum(1 for t in self.tasks if t.kind == "stage"),
            "gang": sum(1 for t in self.tasks if t.group is not None),
            "groups": sorted({t.group.label() for t in self.tasks
                              if t.group is not None}),
            "done": by_state.get(DONE, 0),
            "failed": by_state.get(FAILED, 0),
            "workers": sorted({t.worker.name for t in self.tasks if t.worker}),
            "wall_ms": (time.perf_counter() - self._t0) * 1e3,
        }

    def explain(self) -> str:
        """Render the job DAG: one line per task with kind, owning worker,
        communicator group, dependencies, state and duration — the
        cross-worker complement of ``df.explain()``'s per-lineage plan."""
        lines = [f"== job {self.name!r} ({len(self.tasks)} tasks) =="]
        for t in sorted(self.tasks, key=lambda t: t.id):
            deps = ",".join(f"t{d.id}" for d in t.deps) or "-"
            wname = t.worker.name if t.worker is not None else "?"
            gname = f"  group={t.group.label()}" if t.group is not None else ""
            dur = f"{t.duration_ms:.1f}ms" if t.t_end else ""
            lines.append(
                f"  t{t.id} {t.kind}:{t.name}  worker={wname}{gname}  "
                f"deps=[{deps}]  {t.state} {dur}".rstrip()
            )
        return "\n".join(lines)
