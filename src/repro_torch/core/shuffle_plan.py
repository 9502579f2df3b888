"""Adaptive shuffle engine (DESIGN.md §6): capacity memory, fused wide
stages, deferred overflow checks, and shuffle telemetry.

The static-shape tradeoff (DESIGN.md §1) makes every exchange capacity-bound:
a bucket that overflows forces a retry at a new capacity, i.e. a new stage
build and a rerun. The ``ShuffleManager`` closes that gap three ways:

1. **Capacity memory.** Every wide node carries a structural lineage
   signature; the manager remembers, per ``(signature, input rows)``, the
   capacity factor that fit — sized from the *observed* max bucket demand,
   not the worst case — so repeated actions (and re-built identical
   lineages) pick a fitting capacity on the first try: zero retries, zero
   recompiles.
2. **Fused wide stages + wide-plan cache.** sort→segment-heads→segmented-
   reduce chains (reduceByKey / distinct / groupByKey) run as ONE stage
   (shuffle.sort_stage + post hook) over every rank; built stages live in
   an LRU keyed by (op kind, capacity, fn tokens, block avals,
   communicator) — the wide-op analogue of the narrow plan cache
   (DESIGN.md §5).
3. **Deferred overflow checks.** Stages return device scalars; the
   manager performs ONE host sync per wide node (none at p=1 for
   sorts/exchanges), retries at a capacity derived from the observed fill
   (guaranteed to fit — the fill is demand, independent of capacity), and
   records the outcome.

Telemetry lives in ``stats`` (exchanges, overflow/fan-out retries, deferred
checks, capacity-memory hits, wide-plan compiles, bytes moved) — surfaced via
``worker.shuffle_stats()`` and the ``== shuffle ==`` section of
``df.explain()``.
"""
from __future__ import annotations

import threading
import time
import types
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import comm, faults, tree
from repro_torch.core import shuffle as sh
from repro_torch.core.executor import _vmapped
from repro_torch.core.metrics import Counters
from repro_torch.core.partition import (Block, block_aval as _block_aval, block_ranks,
                                        place_block)
from repro_torch.kernels.registry import KernelRegistry, builtin_reduce_op


class _Opaque(Exception):
    """A captured value the token cannot represent faithfully — fall back to
    the function object itself (identity-based, always correct)."""


# value types whose (type, value) pair fully determines traced behavior
_VALUE_TYPES = (int, float, bool, complex, str, bytes, type(None))


def _code_names(code) -> set:
    """Global names referenced by a code object, including nested lambdas."""
    names = set(code.co_names)
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            names |= _code_names(c)
    return names


def _val_token(v, seen: frozenset):
    if isinstance(v, _VALUE_TYPES):
        # tag with the type: 1, 1.0 and True compare equal in Python but
        # trace to different dtypes — they must not share a compiled kernel
        return (type(v).__name__, v)
    if isinstance(v, tuple):
        return ("tuple", tuple(_val_token(x, seen) for x in v))
    if isinstance(v, types.ModuleType):
        return ("module", v.__name__)
    if callable(v):
        return fn_token(v, seen)
    raise _Opaque


def fn_token(fn, _seen: frozenset = frozenset()):
    """Structural identity of a row fn: (code, closure cells, defaults,
    referenced-global values).

    Two lambdas created by re-running the same source line share a code
    object, so re-built lineages (benchmark loops, iterative drivers) map to
    the same token and hit the capacity memory / plan cache. Behavior-bearing
    state is part of the token: closure cell values, defaults, and the values
    of module globals the code references (a rebuilt ``lambda x: x * SCALE``
    after ``SCALE`` changed must NOT reuse the old plan). Falls back to the
    function object itself — identity-based, always correct, just fewer
    cross-rebuild hits — for bound methods (behavior lives in ``__self__``)
    and whenever any captured value is not a plain value type (arrays,
    arbitrary objects: their mutable state is invisible to a token).
    """
    code = getattr(fn, "__code__", None)
    if code is None or getattr(fn, "__self__", None) is not None:
        return fn
    if id(fn) in _seen:  # self-referential function: code identifies the cycle
        return ("recursive", code)
    seen = _seen | {id(fn)}
    try:
        cells: tuple = ()
        if getattr(fn, "__closure__", None):
            cells = tuple(_val_token(c.cell_contents, seen) for c in fn.__closure__)
        defaults = tuple(_val_token(v, seen)
                         for v in (getattr(fn, "__defaults__", None) or ()))
        g = getattr(fn, "__globals__", {})
        gtok = tuple((name, _val_token(g[name], seen))
                     for name in sorted(_code_names(code)) if name in g)
        token = ("fn", code, cells, defaults, gtok)
        hash(token)
    except (_Opaque, TypeError):
        return fn
    return token


def _static_token(x):
    """Hashable token for a static pytree argument (e.g. a reduce identity).

    Tensor leaves (hashable by identity only) and unhashable leaves are
    fingerprinted by dtype/shape/bytes — repr() would truncate large arrays
    and collide distinct identities."""
    leaves, treedef = tree.flatten(x)
    if not any(isinstance(l, torch.Tensor) for l in leaves):
        try:
            hash(x)
            return x
        except TypeError:
            pass

    def leaf(l):
        a = l.detach().cpu().numpy() if isinstance(l, torch.Tensor) else np.asarray(l)
        return (str(a.dtype), a.shape, a.tobytes())

    return (treedef, tuple(leaf(l) for l in leaves))


def _row_bytes(b: Block, key_bytes: int = 8) -> int:
    """Approximate bytes per exchanged row (payload leaves + key + validity)."""
    per = sum(
        int(np.prod(l.shape[1:], dtype=np.int64)) * l.element_size()
        for l in tree.leaves(b.data)
    )
    return per + key_bytes + 1


class ShuffleManager:
    """Runs every wide (shuffle-backed) operator for one worker."""

    MAX_ATTEMPTS = 8  # join retry bound (capacity + fan-out combined)
    MEMORY_ENTRIES = 4096  # capacity/fan-out memory cap (FIFO eviction)

    def __init__(self, ctx, *, worker=None, capacity_factor: float = 2.0,
                 join_max_matches: int = 8, plan_cache_size: int = 64,
                 headroom: float = 1.25, kernels: Optional[KernelRegistry] = None):
        # with a worker, the manager follows the worker's CURRENT context —
        # a gang-scheduled task (core/job.py) swaps in a group communicator
        # and every wide stage runs on the group's ranks
        self._ctx = ctx
        self._worker = worker
        self.default_factor = float(capacity_factor)
        self.join_max_matches = int(join_max_matches)
        self.plan_cache_size = int(plan_cache_size)
        self.headroom = float(headroom)
        # kernel tier (docs/kernels.md): capability/selection + autotune
        # memo, consulted once per kernel-eligible wide node
        self.kernels = (kernels if kernels is not None
                        else KernelRegistry(device=ctx.device))
        self._capacity: "OrderedDict[tuple, float]" = OrderedDict()
        self._fanout: "OrderedDict[tuple, int]" = OrderedDict()
        self._kernel_notes: "OrderedDict[object, str]" = OrderedDict()
        self._op_memo: "OrderedDict[tuple, Optional[str]]" = OrderedDict()
        self._plans: "OrderedDict[tuple, Callable]" = OrderedDict()
        # gang-scheduled tasks on disjoint groups share this manager from
        # several threads; LRU get+move / insert+evict, the capacity/fanout
        # memories, and the stats counters (CI-gated by check_bench.py —
        # a lost `overflow_retries` increment could mask a regression) all
        # need their read-modify-write sequences kept atomic
        self._plan_lock = threading.Lock()
        # the "shuffle/" namespace of the worker's metrics tree
        # (core/metrics.py; worker.shuffle_stats() is the legacy facade)
        self.stats = Counters("shuffle", {
            "exchanges": 0,            # collective exchange stages executed
            "overflow_retries": 0,     # capacity retries (recompile + rerun)
            "fanout_retries": 0,       # join per-key match-bound doublings
            "overflow_checks": 0,      # deferred host syncs performed
            "capacity_memory_hits": 0,
            "capacity_memory_misses": 0,
            "wide_plan_hits": 0,
            "wide_plan_misses": 0,     # wide-stage compiles
            "wide_plan_evictions": 0,
            "bytes_moved": 0,          # exchanged-buffer bytes (estimate)
            "group_reshards": 0,       # blocks moved onto a different communicator
        })

    # ------------------------------------------------------------------
    # communicator binding
    # ------------------------------------------------------------------
    @property
    def ctx(self):
        return self._worker.context if self._worker is not None else self._ctx

    def _bump(self, key: str, n: int = 1):
        with self._plan_lock:
            self.stats[key] += n

    def _placed(self, b: Block) -> Block:
        """Commit a block to the active communicator before a wide stage —
        the ingress half of the inter-group reshard edge. A block committed
        to the world's ranks (or another group's) is placed onto this
        communicator and counted; resident blocks pass through. An
        uncommitted block on another device only moves."""
        ctx = self.ctx
        ranks = block_ranks(b)
        if ranks is not None and ranks != frozenset(ctx.ranks):
            self._bump("group_reshards")
            return place_block(b, ctx)
        if b.device != ctx.device:
            return place_block(b, ctx)
        return b

    # ------------------------------------------------------------------
    # capacity memory
    # ------------------------------------------------------------------
    @property
    def p(self) -> int:
        return self.ctx.executors

    def _factor(self, sig, rows) -> float:
        with self._plan_lock:
            f = self._capacity.get((sig, rows, self.p))
            if f is not None:
                self.stats["capacity_memory_hits"] += 1
                return f
            self.stats["capacity_memory_misses"] += 1
            return self.default_factor

    def _remember(self, sig, rows, factor: float):
        # keyed per communicator size: the fitting factor on a p=4 group is
        # not the fitting factor on the p=8 world for the same lineage
        with self._plan_lock:
            mem = self._capacity
            mem[(sig, rows, self.p)] = factor
            while len(mem) > self.MEMORY_ENTRIES:
                mem.popitem(last=False)

    def _fit(self, fill: int, n_local: int) -> float:
        """Capacity factor sized from observed bucket demand, with headroom,
        capped at the guaranteed-fit worst case (factor = p)."""
        base = fill * self.p / max(n_local, 1)
        return float(min(max(base * self.headroom, self.default_factor), self.p))

    # ------------------------------------------------------------------
    # wide-plan cache (compiled stage kernels; analogue of DESIGN.md §5)
    # ------------------------------------------------------------------
    def _plan(self, key: tuple, build_plan: Callable[[], Callable]):
        with self._plan_lock:
            fn = self._plans.get(key)
            if fn is not None:
                self._plans.move_to_end(key)
                self.stats["wide_plan_hits"] += 1
                return fn
            self.stats["wide_plan_misses"] += 1
        fn = build_plan()
        with self._plan_lock:
            self._plans[key] = fn
            while len(self._plans) > self.plan_cache_size:
                self._plans.popitem(last=False)
                self.stats["wide_plan_evictions"] += 1
        return fn

    def _account(self, b: Block, C: int):
        p = self.p
        if p > 1:
            with self._plan_lock:
                self.stats["exchanges"] += 1
                self.stats["bytes_moved"] += p * p * C * _row_bytes(b)

    def _adaptive(self, sig, rows, n_local: int, run) -> tuple:
        """The shared capacity sequence for single-exchange wide ops:
        memory lookup → run at the predicted capacity → one deferred
        overflow check → at most one fitted retry → remember what fit.
        ``run(C) -> (out, overflow, max_fill)``. The fitted retry cannot
        overflow again: max_fill is bucket *demand*, independent of C."""
        factor = self._factor(sig, rows)
        out, ovf, fill = run(sh.capacity_for(factor, n_local, self.p))
        if self.p > 1:
            self._bump("overflow_checks")
            # the deferred check rides a nonblocking handle: the overflow
            # scalars are the only host sync a wide stage performs, and the
            # handle gives them the same fault surface (``comm.handle``)
            # and telemetry as every other in-flight collective
            h = comm.CollHandle("shuffle.capacity", self.ctx, (ovf, fill))
            n_ovf, n_fill = (int(x) for x in h.wait())
            if n_ovf > 0:
                self._bump("overflow_retries")
                faults.check("shuffle.overflow", kind="capacity", fill=n_fill)
                factor = self._fit(n_fill, n_local)
                out, _, _ = run(sh.capacity_for(factor, n_local, self.p))
        self._remember(sig, rows, factor)
        return out

    # ------------------------------------------------------------------
    # kernel tier plumbing (docs/kernels.md): per-node selection + autotune
    # ------------------------------------------------------------------
    def _note(self, sig, txt: str):
        """Record the kernel selection for ``df.explain()`` annotation."""
        with self._plan_lock:
            self._kernel_notes[sig] = txt
            while len(self._kernel_notes) > self.MEMORY_ENTRIES:
                self._kernel_notes.popitem(last=False)

    def _reduce_op(self, fn, identity, value) -> Optional[str]:
        """Memoised ``builtin_reduce_op``: tracing costs milliseconds per
        call, which a fresh lineage would otherwise pay on EVERY
        reduceByKey — keying by the same fn/static tokens the wide-plan
        cache uses makes repeat consultations a dict hit."""
        if value is None:
            return None
        try:
            key = (fn_token(fn), _static_token(identity),
                   tuple((str(getattr(l, "dtype", "?")), getattr(l, "ndim", 0))
                         for l in tree.leaves(value)))
        except Exception:
            return builtin_reduce_op(fn, identity, value)
        with self._plan_lock:
            if key in self._op_memo:
                self._op_memo.move_to_end(key)
                return self._op_memo[key]
        op = builtin_reduce_op(fn, identity, value)
        with self._plan_lock:
            self._op_memo[key] = op
            while len(self._op_memo) > self.MEMORY_ENTRIES:
                self._op_memo.popitem(last=False)
        return op

    def _time_calls(self, fn, *args) -> float:
        """Median-free micro-timer: one warm-up (which builds the kernel at
        this block size, so no candidate pays its compile in the timing),
        two timed runs. On the card CUDA events bracket the runs."""
        fn(*args)
        dev = self.ctx.device
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            fn(*args)
            fn(*args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        fn(*args)
        fn(*args)
        return time.perf_counter() - t0

    def _block_candidates(self, n: int) -> list:
        # candidates beyond n rows collapse to one tile — dedupe so small
        # inputs sweep (and key) only distinct effective block sizes
        n = max(int(n), 1)
        return sorted({min(int(c), n) for c in self.kernels.blocks})

    def _tune_reduce(self, b: Block, op: str, sel) -> int:
        """Tuned block size for the segment kernel on this block's aval."""
        from repro_torch.kernels.segment_reduce.ops import segment_totals

        leaf = tree.leaves(b.data["value"])[0]
        D = () if leaf.ndim == 1 else tuple(leaf.shape[1:])
        n = b.capacity
        dev = self.ctx.device
        key = ("segment_reduce", op, str(leaf.dtype), D, n,
               sel.interpret, dev.type)

        def timer(c: int) -> float:
            keys = torch.zeros(n, dtype=torch.int32, device=dev)
            valid = torch.ones(n, dtype=torch.bool, device=dev)
            vals = torch.zeros((n, *D), dtype=leaf.dtype, device=dev)
            f = lambda k, v, x: segment_totals(  # noqa: E731
                k, v, x, op=op, identity=0, block=c)
            return self._time_calls(f, keys, valid, vals)

        return self.kernels.tune(key, self._block_candidates(n), timer)

    def _tune_route(self, n_local: int, sel) -> int:
        """Tuned block size for the bucket router at this exchange width."""
        p = self.p
        n = max(int(n_local), 1)
        dev = self.ctx.device
        key = ("bucket_route", p, n, sel.interpret, dev.type)

        def timer(c: int) -> float:
            route = sh.make_bucket_route(p, max(n // p, 1), c)
            return self._time_calls(
                route, torch.zeros((p, n), dtype=torch.int32, device=dev))

        return self.kernels.tune(key, self._block_candidates(n), timer)

    def _select_route(self, sig, n_local: int):
        """Kernel-or-fallback decision for a hash-routed exchange: returns
        (selection, tuned_block), (None, None) for the argsort path."""
        if self.p <= 1:  # no exchange, nothing to route
            return None, None
        sel = self.kernels.select("bucket_route")
        if sel is None:
            return None, None
        # no try: a sweep that fails to build or launch raises (registry.py)
        blk = self._tune_route(n_local, sel)
        self._note(sig, f"{sel.describe()} block={blk}")
        return sel, blk

    # ------------------------------------------------------------------
    # sort-routed wide ops (sort / distinct / reduceByKey / groupByKey)
    # ------------------------------------------------------------------
    def _sorted(self, sig, b: Block, key_fn, ascending: bool, post, kind: tuple,
                kernel: Optional[str] = None) -> Block:
        b = self._placed(b)
        rows = b.capacity
        n_local = rows // max(self.p, 1)
        data, valid = self._adaptive(
            sig, rows, n_local,
            lambda C: self._run_sort_stage(kind, C, b, key_fn, ascending, post,
                                           kernel=kernel))
        return Block(data, valid)

    def _run_sort_stage(self, kind, C, b, key_fn, ascending, post, kernel=None):
        ctx = self.ctx
        # the communicator is part of the key: a stage built for a p=4 group
        # closes over that group's communicator and must never serve the
        # world (or another group over other ranks)
        key = (kind, C, ascending, fn_token(key_fn), _block_aval(b), ctx.key)

        def build_plan():
            def run(data, valid):
                keys = _vmapped(key_fn)(data)
                if not ascending:
                    keys = -keys
                return sh.sort_stage(ctx, keys, valid, data, C, post)

            return run

        fn = self._plan(key, build_plan)
        self._account(b, C)
        faults.check("shuffle.stage", kind=kind[0], p=self.p)
        if kernel is not None:
            faults.check("kernel.stage", kind=kind[0], kernel=kernel, p=self.p)
        return fn(b.data, b.valid)

    def sort(self, sig, b: Block, key_fn, ascending: bool = True) -> Block:
        return self._sorted(sig, b, key_fn, ascending, None, ("sort",))

    def distinct(self, sig, b: Block, key_fn) -> Block:
        return self._sorted(sig, b, key_fn, True, sh.heads_post, ("distinct",))

    def reduce_by_key(self, sig, b: Block, fn, identity) -> Block:
        # kernel tier: a builtin sum/max/min over a single supported leaf
        # runs on the segment kernel; everything else (arbitrary fns, tree
        # values, unsupported dtypes) keeps the plain path
        value = b.data.get("value") if isinstance(b.data, dict) else None
        op = self._reduce_op(fn, identity, value)
        sel = self.kernels.select("segment_reduce") if op is not None else None
        if sel is not None:
            # no try: a sweep that fails to build or launch raises
            blk = self._tune_reduce(b, op, sel)
            self._note(sig, f"{sel.describe()} op={op} block={blk}")
            post = sh.make_reduce_post_kernel(op, identity, block=blk)
            # the tuned block is part of the wide-plan key: a re-tune (memo
            # eviction) that lands on a different block recompiles, a memo
            # hit re-uses the compiled stage — zero recompiles on repeats
            kind = ("reduceByKey", "kernel", op, blk, sel.interpret,
                    _static_token(identity))
            return self._sorted(sig, b, lambda r: r["key"], True, post, kind,
                                kernel="segment_reduce")
        vfn = lambda a, c: tree.map(lambda x, y: fn(x, y), a, c)  # noqa: E731
        post = sh.make_reduce_post(vfn, identity)
        kind = ("reduceByKey", fn_token(fn), _static_token(identity))
        return self._sorted(sig, b, lambda r: r["key"], True, post, kind)

    def group_by_key(self, sig, b: Block, group_capacity: int) -> Block:
        post = sh.make_group_post(group_capacity)
        kind = ("groupByKey", group_capacity)
        return self._sorted(sig, b, lambda r: r["key"], True, post, kind)

    # ------------------------------------------------------------------
    # hash-routed wide ops (partitionBy)
    # ------------------------------------------------------------------
    def partition_by(self, sig, b: Block, key_fn) -> Block:
        b = self._placed(b)
        rows = b.capacity
        n_local = rows // max(self.p, 1)
        sel, blk = self._select_route(sig, n_local)
        data, valid = self._adaptive(
            sig, rows, n_local,
            lambda C: self._run_hash_stage(C, b, key_fn, sel=sel, blk=blk))
        return Block(data, valid)

    def _run_hash_stage(self, C, b, key_fn, sel=None, blk=None):
        ctx = self.ctx
        route = None
        ktag = ()
        if sel is not None:
            route = sh.make_bucket_route(self.p, C, blk)
            ktag = ("kernel", blk, sel.interpret)
        key = (("partitionBy",) + ktag, C, fn_token(key_fn), _block_aval(b), ctx.key)

        def build_plan():
            def run(data, valid):
                keys = _vmapped(key_fn)(data)
                return sh.hash_stage(ctx, keys, valid, data, C, route=route)

            return run

        fn = self._plan(key, build_plan)
        self._account(b, C)
        faults.check("shuffle.stage", kind="partitionBy", p=self.p)
        if sel is not None:
            faults.check("kernel.stage", kind="partitionBy",
                         kernel="bucket_route", p=self.p)
        return fn(b.data, b.valid)

    # ------------------------------------------------------------------
    # join (both-side exchange + bounded-fan-out merge, one stage)
    # ------------------------------------------------------------------
    def join(self, sig, lb: Block, rb: Block, max_matches: int) -> Block:
        lb, rb = self._placed(lb), self._placed(rb)
        p = self.p
        nl, nr = lb.capacity, rb.capacity
        nl_local, nr_local = nl // max(p, 1), nr // max(p, 1)
        factor = self._factor(sig, (nl, nr))
        with self._plan_lock:
            M = self._fanout.get((sig, nl, nr, p), max_matches)
        sel, blk = self._select_route(sig, max(nl_local, nr_local))
        ctx = self.ctx
        attempts = 0
        while True:
            attempts += 1
            Cl = sh.capacity_for(factor, nl_local, p)
            Cr = sh.capacity_for(factor, nr_local, p)
            route_l = route_r = None
            ktag = ()
            if sel is not None:
                route_l = sh.make_bucket_route(p, Cl, blk)
                route_r = sh.make_bucket_route(p, Cr, blk)
                ktag = ("kernel", blk, sel.interpret)
            key = (("join", M) + ktag, Cl, Cr, _block_aval(lb), _block_aval(rb),
                   ctx.key)

            def build_plan(Cl=Cl, Cr=Cr, M=M, route_l=route_l, route_r=route_r):
                def run(ld, lv, rd, rv):
                    return sh.join_stage(ctx, ld["key"], lv, ld["value"],
                                         rd["key"], rv, rd["value"], Cl, Cr, M,
                                         route_l=route_l, route_r=route_r)

                return run

            fn = self._plan(key, build_plan)
            if p > 1:
                self._account(lb, Cl)
                self._account(rb, Cr)
            faults.check("shuffle.stage", kind="join", p=p, attempt=attempts - 1)
            if sel is not None:
                faults.check("kernel.stage", kind="join", kernel="bucket_route",
                             p=p, attempt=attempts - 1)
            rows, ok, eovf, lfill, rfill, fovf = fn(lb.data, lb.valid, rb.data, rb.valid)
            # one deferred check covers both exchanges AND the fan-out bound
            self._bump("overflow_checks")
            h = comm.CollHandle("shuffle.join", self.ctx, (eovf, lfill, rfill, fovf))
            n_e, n_lf, n_rf, n_f = (int(x) for x in h.wait())
            if n_e == 0 and n_f == 0:
                break
            if attempts >= self.MAX_ATTEMPTS:
                # never silently truncate (and never remember the failing
                # bounds): overflow is detected, not swallowed — DESIGN.md §1
                raise RuntimeError(
                    f"join overflow unresolved after {attempts} attempts "
                    f"(exchange_overflow={n_e}, fanout_overflow={n_f}, M={M}): "
                    f"raise max_matches / ignis.join.max.matches for this key skew")
            if n_e > 0:
                self._bump("overflow_retries")
                factor = max(self._fit(n_lf, nl_local), self._fit(n_rf, nr_local))
            else:
                self._bump("fanout_retries")
                M *= 2
        self._remember(sig, (nl, nr), factor)
        with self._plan_lock:
            self._fanout[(sig, nl, nr, p)] = M
            while len(self._fanout) > self.MEMORY_ENTRIES:
                self._fanout.popitem(last=False)
        return Block(rows, ok)

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def annotate(self, node) -> str:
        """Per-node suffix for DagEngine.explain — shuffle capacity state
        plus the kernel-tier selection (docs/kernels.md)."""
        sig = getattr(node, "shuffle_sig", None)
        if sig is None:
            return ""
        knote = self._kernel_notes.get(sig)
        kernel = f" kernel={knote}" if knote else ""
        factors = [f for (s, _rows, _p), f in self._capacity.items() if s == sig]
        if factors:
            return f" {{shuffle: capacity_factor={factors[-1]:.2f} (memory){kernel}}}"
        return f" {{shuffle: capacity_factor={self.default_factor:.2f} (cold){kernel}}}"

    def summary(self) -> str:
        s = self.stats
        return (
            "== shuffle ==\n"
            f"exchanges={s['exchanges']} overflow_retries={s['overflow_retries']} "
            f"fanout_retries={s['fanout_retries']} overflow_checks={s['overflow_checks']}\n"
            f"capacity_memory: hits={s['capacity_memory_hits']} "
            f"misses={s['capacity_memory_misses']} entries={len(self._capacity)}\n"
            f"wide plans: compiled={s['wide_plan_misses']} hits={s['wide_plan_hits']} "
            f"evictions={s['wide_plan_evictions']} bytes_moved={s['bytes_moved']} "
            f"group_reshards={s['group_reshards']}\n"
            f"kernels: {self.kernels.describe()}"
        )
