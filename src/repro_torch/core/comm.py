"""The "MPI" layer: collectives over virtual ranks (paper §2.2, §3.6).

Every routine takes an IContext (the communicator) and operates on flat
``(N, …)`` tensors whose rows are rank-major: rank ``r`` of ``p`` holds rows
``[r·N/p, (r+1)·N/p)``. A collective is a tensor op over the rank axis of the
``(p, N/p, …)`` view — ``alltoall`` is a transpose of ``(p_src, p_dst, k, …)``,
``allreduce`` a reduction over every row — so the same code runs on the CPU
and on the card.

Three call shapes per collective, as in the reference:

* **blocking** — ``allreduce(ctx, x)``: dispatch + ``wait()``; the result is
  ready when the call returns.
* **nonblocking** — ``iallreduce(ctx, x) -> CollHandle``: the
  MPI_Iallreduce shape. The work is queued (torch's CUDA calls return
  before the card finishes) and the handle is the future: ``wait()`` is
  MPI_Wait, ``test()`` MPI_Test. Where the tensors live on the card a
  handle wraps a CUDA event recorded on the current stream, and is in
  flight until that event completes.
* **persistent** — ``persistent(ctx, "allreduce", x) -> CollPlan``: the
  MPI_*_init / MPI_Start shape. Each collective's body is built once per
  (collective, static args, operand avals, communicator) and cached in a
  process-wide LRU; ``plan.start(x)`` re-invokes it. The i* and blocking
  entry points route through the same cache, and ``persistent_program``
  caches a whole native program the same way (``comm_stats()`` counts
  calls, hits and misses as the reference does).

Fault injection: ``handle.wait()`` of a still-pending handle passes the
``comm.handle`` site, so chaos plans can kill a collective between dispatch
and completion.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
from collections import OrderedDict
from typing import Callable, Optional

import torch

from repro_torch.core import faults, tree
from repro_torch.core.context import IContext
from repro_torch.core.metrics import Counters

_handle_ids = itertools.count()


# ---------------------------------------------------------------------------
# handles (MPI_Request)
# ---------------------------------------------------------------------------


def _cuda_event(value):
    """A CUDA event recorded after ``value``'s producers, or None when no
    leaf lives on the card."""
    for l in tree.leaves(value):
        if isinstance(l, torch.Tensor) and l.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(l.device))
            return ev
    return None


class CollHandle:
    """Future for a dispatched collective or device read.

    The operation is already queued when the handle exists (torch's CUDA
    calls return before the card finishes); ``wait()`` blocks until the
    device result is ready and returns it. ``wait()`` is idempotent — a
    second wait returns the same completed value without re-entering the
    fault site. ``test()`` is the nonblocking completion probe.

    Handles created inside a job task are tracked (``track()``); any handle
    the task never awaited is drained by the scheduler at task end.
    Completion is thread-safe: a per-handle lock makes exactly one thread
    finalise (apply ``_transform`` and publish the value).
    """

    __slots__ = ("coll", "ctx", "id", "_value", "_transform", "_done", "_scope",
                 "_lock", "_event")

    def __init__(self, coll: str, ctx, value, transform: Optional[Callable] = None):
        self.coll = coll
        self.ctx = ctx  # the issuing communicator
        self.id = next(_handle_ids)
        self._value = value
        self._transform = transform
        self._done = False
        self._lock = threading.Lock()
        self._event = _cuda_event(value)
        scope = getattr(_scopes, "pending", None)
        self._scope = scope
        if scope is not None:
            scope.append(self)
        _engine.stats_bump("handles_created")

    # -- introspection ---------------------------------------------------
    @property
    def pending(self) -> bool:
        return not self._done

    def done(self) -> bool:
        """MPI_Test's completion half: True once the device result is ready
        (never blocks)."""
        if self._done:
            return True
        return self._event is None or self._event.query()

    def test(self):
        """MPI_Test: ``(True, value)`` when complete, ``(False, None)``
        otherwise. Completion via test() finalises the handle like wait()."""
        if not self._done and not self.done():
            return False, None
        return True, self.wait()

    # -- completion ------------------------------------------------------
    def wait(self, _phase: str = "wait"):
        """MPI_Wait: block until the collective completes, return its value.
        The ``comm.handle`` fault site fires here while the handle is still
        pending; an injected failure leaves the handle pending so a scheduler
        retry re-issues the collective."""
        if self._done:  # fast path: _done is published AFTER _value (below)
            return self._value
        with self._lock:
            if self._done:
                return self._value
            faults.check("comm.handle", coll=self.coll, phase=_phase)
            if self._event is not None:
                self._event.synchronize()
            value = self._value
            if self._transform is not None:
                value = self._transform(value)
            self._value = value
            self._transform = None
            self._done = True  # publish: value must be stored first
            scope = self._scope
            if scope is not None:
                self._scope = None
                try:
                    scope.remove(self)
                except ValueError:
                    pass
        _engine.stats_bump("handles_awaited")
        return self._value

    def chain(self, fn: Callable) -> "CollHandle":
        """Append a host-side transform applied to the awaited value."""
        with self._lock:
            if self._done:
                self._value = fn(self._value)
                return self
            prev = self._transform
            self._transform = fn if prev is None else (lambda v: fn(prev(v)))
            return self

    def __repr__(self):
        state = "done" if self._done else "pending"
        return f"<CollHandle #{self.id} {self.coll} [{state}]>"


def is_handle(x) -> bool:
    return isinstance(x, CollHandle)


def wait_all(handles) -> list:
    """MPI_Waitall over an iterable of handles (completion in given order)."""
    return [h.wait() for h in handles]


_scopes = threading.local()


@contextlib.contextmanager
def track():
    """Collect every handle created on this thread inside the block. The job
    scheduler wraps each task attempt in one ``track()`` scope and drains
    whatever is still pending when the task function returns."""
    prev = getattr(_scopes, "pending", None)
    cur: list[CollHandle] = []
    _scopes.pending = cur
    try:
        yield cur
    finally:
        _scopes.pending = prev


# ---------------------------------------------------------------------------
# plan engine (build once / invoke many)
# ---------------------------------------------------------------------------


class CommEngine:
    """Process-wide collective plans + telemetry: one built body per
    (collective, static args, operand avals, communicator) in an LRU, so a
    plan built for a p=4 group never serves the p=8 world."""

    def __init__(self, plan_cache_size: int = 128):
        self.plan_cache_size = plan_cache_size
        self._plans: "OrderedDict[tuple, Callable]" = OrderedDict()
        self._building: dict = {}  # key -> Event: build in flight
        self._lock = threading.Lock()
        self.stats = Counters("coll", {
            "coll_calls": 0,          # collectives dispatched
            "coll_plan_hits": 0,      # plan cache hits
            "coll_plan_misses": 0,    # plan builds
            "coll_plan_evictions": 0,
            "handles_created": 0,
            "handles_awaited": 0,
        })

    def stats_bump(self, key: str, n: int = 1):
        with self._lock:
            self.stats[key] += n

    def plan(self, key: tuple, build_plan: Callable[[], Callable]) -> Callable:
        """The plan for ``key``, building on miss. Exactly one thread builds
        a given key: a concurrent miss parks on the building thread's event and
        re-reads the cache."""
        while True:
            with self._lock:
                fn = self._plans.get(key)
                if fn is not None:
                    self._plans.move_to_end(key)
                    self.stats["coll_plan_hits"] += 1
                    return fn
                building = self._building.get(key)
                if building is None:
                    self._building[key] = building = threading.Event()
                    self.stats["coll_plan_misses"] += 1
                    break
            building.wait()
        try:
            fn = build_plan()
        except BaseException:
            with self._lock:
                self._building.pop(key, None)
            building.set()
            raise
        with self._lock:
            self._plans[key] = fn
            self._building.pop(key, None)
            while len(self._plans) > self.plan_cache_size:
                self._plans.popitem(last=False)
                self.stats["coll_plan_evictions"] += 1
        building.set()
        return fn

    def clear(self):
        with self._lock:
            self._plans.clear()


_engine = CommEngine()


def engine() -> CommEngine:
    return _engine


def comm_stats() -> dict:
    """Snapshot of the collective engine telemetry."""
    with _engine._lock:
        return dict(_engine.stats)


def _aval(x) -> tuple:
    return tuple((tuple(l.shape), str(l.dtype)) for l in tree.leaves(x))


class CollPlan:
    """An initialised persistent collective (MPI_Allreduce_init analogue):
    ``start()`` dispatches one invocation and returns its ``CollHandle``
    (MPI_Start); calling the plan is the blocking facade. The body is
    shared through the process-wide plan cache, so equivalent plans (same
    collective, statics, avals, communicator) cost one build total."""

    __slots__ = ("coll", "ctx", "_fn", "_transform", "_prep")

    def __init__(self, coll: str, ctx, fn: Callable, transform=None, prep=None):
        self.coll = coll
        self.ctx = ctx
        self._fn = fn
        self._transform = transform
        self._prep = prep  # operand placement on the communicator's device

    def start(self, *operands) -> CollHandle:
        """Dispatch one invocation (MPI_Start) → nonblocking handle."""
        if self._prep is not None:
            operands = self._prep(*operands)
        _engine.stats_bump("coll_calls")
        return CollHandle(self.coll, self.ctx, self._fn(*operands),
                          transform=self._transform)

    def __call__(self, *operands):
        return self.start(*operands).wait()


# ---------------------------------------------------------------------------
# collective builders: each returns the CollPlan of one collective
# ---------------------------------------------------------------------------


def _ranked(ctx: IContext, x) -> torch.Tensor:
    """The ``(p, N/p, …)`` rank view of a flat operand."""
    p = ctx.executors
    if x.shape[0] % p:
        raise ValueError(f"{x.shape[0]} rows do not split over {p} executors")
    return x.reshape(p, x.shape[0] // p, *x.shape[1:])


def _sum_dtype(dtype):
    # the reference's integer sums stay 32-bit (bool sums to int32)
    return torch.int32 if dtype in (torch.bool, torch.int32, torch.int16,
                                    torch.int8, torch.uint8) else dtype


def _reducer(op: str):
    if op == "sum":
        return lambda x: x.sum(dim=0).to(_sum_dtype(x.dtype))
    if op == "max":
        return lambda x: x.any(dim=0) if x.dtype == torch.bool else x.amax(dim=0)
    if op == "min":
        return lambda x: x.all(dim=0) if x.dtype == torch.bool else x.amin(dim=0)
    raise ValueError(f"allreduce op must be one of ['max', 'min', 'sum'], got {op!r}")


def _plan_for(ctx: IContext, coll: str, statics: tuple, x,
              build_plan: Callable[[], Callable]) -> CollPlan:
    fn = _engine.plan((coll, statics, _aval(x), ctx.key), build_plan)
    return CollPlan(coll, ctx, fn,
                    prep=lambda *ops: tuple(ctx.place(o) for o in ops))


def _allreduce_plan(ctx: IContext, x, op: str) -> CollPlan:
    red = _reducer(op)
    return _plan_for(ctx, "allreduce", (op,), x, lambda: red)


def _gather_plan(ctx: IContext, x) -> CollPlan:
    return _plan_for(ctx, "gather", (), x, lambda: lambda v: v.clone())


def _alltoall_check(ctx: IContext, x):
    p = ctx.executors
    n = x.shape[0]
    if n % p or (n // p) % p:
        # a silent reshape here would regroup rows to the WRONG peers
        raise ValueError(
            f"alltoall needs the local row count divisible by the communicator "
            f"size: total {n} rows over {p} executors gives "
            f"{n / p:g} local rows, which must be a multiple of {p}")


def _alltoall_plan(ctx: IContext, x) -> CollPlan:
    """MPI_Alltoall. x: (p·p·k, …); rank i holds, in order, the k rows for
    each peer. Returns the same shape with rows regrouped by source."""
    _alltoall_check(ctx, x)  # before any plan work: an invalid shape never flies
    p = ctx.executors

    def build_plan():
        def f(v):
            k = v.shape[0] // (p * p)
            y = v.reshape(p, p, k, *v.shape[1:]).transpose(0, 1)
            return y.reshape(v.shape)

        return f

    return _plan_for(ctx, "alltoall", (), x, build_plan)


def _ppermute_plan(ctx: IContext, x, shift: int) -> CollPlan:
    def build_plan():
        return lambda v: torch.roll(_ranked(ctx, v), shift, dims=0).reshape(v.shape)

    return _plan_for(ctx, "ppermute", (shift,), x, build_plan)


def _exscan_plan(ctx: IContext, x, op: str) -> CollPlan:
    """MPI_Exscan (exclusive prefix over executor ranks) of per-rank
    scalars. x: (p,), one scalar per executor."""
    if op != "sum":
        raise ValueError(f"exscan supports op='sum' only, got {op!r}")

    def build_plan():
        def f(v):
            c = torch.cumsum(v, dim=0)
            return (c - v.to(c.dtype)).to(_sum_dtype(v.dtype))

        return f

    return _plan_for(ctx, "exscan", (op,), x, build_plan)


def _barrier_plan(ctx: IContext) -> CollPlan:
    z = torch.zeros((ctx.executors,), dtype=torch.int32, device=ctx.device)
    return CollPlan(
        "barrier", ctx,
        lambda: _engine.plan(("barrier", (), _aval(z), ctx.key),
                             lambda: lambda v: v.sum())(z),
        transform=lambda _v: None)


# ---------------------------------------------------------------------------
# the persistent API (init once / invoke many)
# ---------------------------------------------------------------------------

_PLAN_BUILDERS = {
    "allreduce": lambda ctx, x, op="sum": _allreduce_plan(ctx, x, op),
    "reduce": lambda ctx, x, op="sum": _allreduce_plan(ctx, x, op),
    "gather": _gather_plan,
    "alltoall": _alltoall_plan,
    "ppermute": lambda ctx, x, shift=1: _ppermute_plan(ctx, x, shift),
    "exscan": lambda ctx, x, op="sum": _exscan_plan(ctx, x, op),
}


def persistent(ctx: IContext, coll: str, x=None, **statics) -> CollPlan:
    """Initialise a persistent collective plan for operands shaped like
    ``x`` (MPI_*_init): ``plan.start(x)`` dispatches an invocation,
    ``plan(x)`` is the blocking facade. Plans are cheap to re-create — the
    body lives in the process-wide LRU, so init-once is a cache property,
    not an object-lifetime obligation."""
    if coll == "barrier":
        return _barrier_plan(ctx)
    if coll in ("bcast", "scatter"):  # placement only: no plan to build
        return CollPlan(coll, ctx, lambda v: ctx.place(v))
    builder = _PLAN_BUILDERS.get(coll)
    if builder is None:
        raise ValueError(f"unknown collective {coll!r} "
                         f"(have {sorted(_PLAN_BUILDERS) + ['barrier', 'bcast', 'scatter']})")
    if x is None:
        raise ValueError(f"persistent({coll!r}) needs a prototype operand")
    return builder(ctx, x, **statics)


def persistent_program(tag: str, comm, statics: tuple,
                       build_plan: Callable[[], Callable]) -> Callable:
    """Build-once/invoke-many plan for a whole SPMD program (a native
    app's body over every rank): the same LRU and telemetry as the
    single-collective plans, keyed by ``("spmd", tag, statics, comm)``.
    ``comm`` is the communicator's identity — ``ctx.key``, or the
    ``(ranks, axis)`` pair of ``ctx.comm()`` with the operands' device
    among the statics."""
    return _engine.plan(("spmd", tag, statics, comm), build_plan)


# ---------------------------------------------------------------------------
# nonblocking collectives (MPI_I* — dispatch now, CollHandle as the future)
# ---------------------------------------------------------------------------


def iallreduce(ctx: IContext, x, op: str = "sum") -> CollHandle:
    """MPI_Iallreduce over every rank's rows: (N, …) → (…) replicated."""
    return _allreduce_plan(ctx, x, op).start(x)


def ireduce(ctx: IContext, x, op: str = "sum") -> CollHandle:
    """MPI_Ireduce (root=driver): same pattern as allreduce on one device."""
    return iallreduce(ctx, x, op)


def ibcast(ctx: IContext, x) -> CollHandle:
    """MPI_Ibcast: replicate a driver value across executors."""
    _engine.stats_bump("coll_calls")
    return CollHandle("bcast", ctx, ctx.place(x))


def igather(ctx: IContext, x) -> CollHandle:
    """MPI_Iallgather: rank-sharded (n, …) → replicated (n, …)."""
    return _gather_plan(ctx, x).start(x)


def iscatter(ctx: IContext, x) -> CollHandle:
    """MPI_Iscatter: replicated (n, …) → rank-sharded (n, …)."""
    _engine.stats_bump("coll_calls")
    return CollHandle("scatter", ctx, ctx.place(x))


def ialltoall(ctx: IContext, x) -> CollHandle:
    """MPI_Ialltoall — shape validation is eager (the ValueError fires at
    dispatch, not at wait: an invalid exchange must never enter flight)."""
    return _alltoall_plan(ctx, x).start(x)


def ippermute(ctx: IContext, x, shift: int = 1) -> CollHandle:
    """MPI_Isend/Irecv ring: rank i's rows go to rank (i+shift) % p."""
    return _ppermute_plan(ctx, x, shift).start(x)


def iexscan(ctx: IContext, x, op: str = "sum") -> CollHandle:
    return _exscan_plan(ctx, x, op).start(x)


def ibarrier(ctx: IContext) -> CollHandle:
    """MPI_Ibarrier: a zero-byte allreduce in flight; wait() returns None."""
    return _barrier_plan(ctx).start()


# ---------------------------------------------------------------------------
# blocking facades (each is literally i*(…).wait())
# ---------------------------------------------------------------------------


def allreduce(ctx: IContext, x, op: str = "sum"):
    """MPI_Allreduce: blocking facade over ``iallreduce``."""
    return iallreduce(ctx, x, op).wait()


def reduce(ctx: IContext, x, op: str = "sum"):
    """MPI_Reduce (root=driver): same pattern as allreduce on one device."""
    return allreduce(ctx, x, op)


def bcast(ctx: IContext, x):
    """MPI_Bcast: replicate a driver value across executors."""
    return ibcast(ctx, x).wait()


def gather(ctx: IContext, x):
    """MPI_Allgather: rank-sharded (n, …) → replicated (n, …)."""
    return igather(ctx, x).wait()


def scatter(ctx: IContext, x):
    """MPI_Scatter: replicated (n, …) → rank-sharded (n, …)."""
    return iscatter(ctx, x).wait()


def alltoall(ctx: IContext, x):
    """MPI_Alltoall (see ``ialltoall`` for the validation contract)."""
    return ialltoall(ctx, x).wait()


def ppermute(ctx: IContext, x, shift: int = 1):
    """MPI_Sendrecv ring: rank i's rows go to rank (i+shift) % p."""
    return ippermute(ctx, x, shift).wait()


def exscan(ctx: IContext, x, op: str = "sum"):
    """MPI_Exscan (exclusive prefix over executor ranks) of per-rank scalars."""
    return iexscan(ctx, x, op).wait()


def barrier(ctx: IContext):
    """MPI_Barrier: a zero-byte allreduce, blocked on."""
    ibarrier(ctx).wait()


def shard_rows(ctx: IContext, x):
    """Place an (N, …) tensor rank-major on the communicator's device."""
    return ctx.place(x)


def replicate(ctx: IContext, x):
    return ctx.place(x)
