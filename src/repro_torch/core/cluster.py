"""Ignis / ICluster / IWorker — the job hierarchy (paper §3.2, Fig. 2).

A *Cluster* owns one torch device and ``ignis.executor.instances`` virtual
executor ranks on it (its "containers"); *Workers* are programming-model
execution contexts on those ranks: dataflow workers and SPMD workers that
interoperate through ``importData`` (the inter-worker communicator: moving a
block between devices, a no-op on the same device).

The cluster's device comes from ``ignis.device`` (``cuda`` by default). A
cluster asked for ``cuda`` where no card is visible raises: it never carries
on quietly on the CPU. Tests pass ``ignis.device=cpu``.

A cluster also has a fixed pool of rank slots (``slots``, by default the
executor count): the counterpart of the devices a JAX process sees. The
elastic mesh (``IWorker.grow``/``shrink``) admits ranks from the free slots
and retires them back into the pool.
"""
from __future__ import annotations

import pickle
import threading
import weakref
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.core import comm as comm_mod
from repro_torch.core import faults, tree
from repro_torch.core.context import IContext
from repro_torch.core.dag import DagEngine, TaskNode, node_sig
from repro_torch.core.dataframe import IDataFrame
from repro_torch.core.metrics import Counters, MetricsTree, warn_deprecated
from repro_torch.core.native import get_app, load_library
from repro_torch.core.partition import (Block, block_aval, concat_blocks,
                                        from_host, place_block)
from repro_torch.core.properties import IProperties
from repro_torch.core.shuffle_plan import ShuffleManager
from repro_torch.core.textlambda import ISource
from repro_torch.kernels.registry import KernelRegistry


class Ignis:
    """Framework lifecycle (paper Fig. 6 lines 6/42)."""

    _started = False

    @classmethod
    def start(cls):
        cls._started = True

    @classmethod
    def stop(cls):
        cls._started = False

    @classmethod
    def running(cls) -> bool:
        return cls._started

    @classmethod
    def scheduler(cls):
        """The process-wide job scheduler."""
        from repro_torch.core.job import default_scheduler

        return default_scheduler()

    @classmethod
    def job(cls, name: str = "job"):
        """Open a named job: a group of async submissions scheduled as one
        cross-worker DAG (paper §3.2 job hierarchy)."""
        from repro_torch.core.job import IJob

        return IJob(name)


class ICluster:
    """A group of executor containers: ``p`` virtual ranks on one device,
    out of ``slots`` rank slots (default: ``p``) a worker may grow into."""

    def __init__(self, props: Optional[IProperties] = None,
                 slots: Optional[int] = None):
        self.props = props or IProperties()
        dev = torch.device(self.props.get("ignis.device", "cuda"))
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ignis.device=cuda but torch sees no CUDA device; set "
                    "ignis.device=cpu to run on the CPU")
            if dev.index is None:  # tensors report cuda:N, never bare cuda
                dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.executors = max(self.props.get_int("ignis.executor.instances", 1), 1)
        self.slots = self.executors if slots is None else int(slots)
        if self.slots < self.executors:
            raise ValueError(f"ICluster: {self.slots} rank slots cannot hold "
                             f"{self.executors} executors")
        self.workers: list[IWorker] = []

    # paper §4: remote commands to containers — host-side here
    def execute(self, fn, *args, **kw):
        return fn(*args, **kw)

    def execute_script(self, src: str):
        scope = {}
        exec(src, scope)  # noqa: S102
        return scope

    def send_file(self, src: str, dst: str):
        with open(src, "rb") as f, open(dst, "wb") as g:
            g.write(f.read())

    sendFile = send_file
    executeScript = execute_script


class IWorker:
    """One programming-model context bound to a cluster (paper §3.2).

    kind: "dataflow" (IDataFrame ops) | "spmd" (native collective apps).
    Both share the cluster's ranks — that is the paper's whole point.
    """

    _GROUP_LOCK_CAP = 256

    def __init__(self, cluster: ICluster, kind: str = "dataflow", name: str = ""):
        if kind in ("python", "cpp", "java"):  # paper-style language names
            kind = "dataflow"
        props = cluster.props
        self.mode = props.get("ignis.mode", "ignis")
        self.cluster = cluster
        self.kind = kind
        self.name = name or f"{kind}-{len(cluster.workers)}"
        self.device = cluster.device
        self._base_context = IContext(cluster.executors, cluster.device, "data",
                                      props, self)
        self._ctx_local = threading.local()
        self.engine = DagEngine(
            fusion=props.get_bool("ignis.fusion.enabled", True),
            plan_cache_size=props.get_int("ignis.fusion.plan.cache.size", 128),
            fusion_mode=props.get("ignis.fusion.mode", "static"),
        )
        # every worker carries a cost model: cost-mode fusion consults it,
        # the scheduler feeds it task-duration history, and
        # ignis.task.speculative.timeout=auto reads that history
        from repro_torch.profile.cost import CostModel

        self.engine.cost_model = CostModel()
        self.capacity_factor = props.get_float("ignis.shuffle.capacity.factor", 2.0)
        self.join_max_matches = props.get_int("ignis.join.max.matches", 8)
        self.shuffle = ShuffleManager(
            self._base_context,
            worker=self,
            capacity_factor=self.capacity_factor,
            join_max_matches=self.join_max_matches,
            plan_cache_size=props.get_int("ignis.shuffle.plan.cache.size", 64),
            headroom=props.get_float("ignis.shuffle.memory.headroom", 1.25),
            kernels=KernelRegistry(
                mode=props.get("ignis.kernels", "auto"),
                blocks=props.get("ignis.kernels.blocks", "128,256,512"),
                tune_cache_size=props.get_int("ignis.kernels.tune.cache.size", 512),
                device=cluster.device,
            ),
        )
        self._libraries: list[str] = []
        # elastic mesh telemetry: resize events and the incremental-reshard
        # split — `reshard_moves` (blocks whose ownership changed, moved as
        # pure data) vs `reshard_unchanged` (cached blocks a resize left in
        # place) vs `reshard_recomputes` (blocks LOST mid-move — the
        # elastic.reshard fault site — left to block-wise lineage repair)
        self.elastic_stats = Counters("elastic", {
            "grows": 0,
            "shrinks": 0,
            "world_size": self._base_context.executors,
            "reshard_moves": 0,
            "reshard_unchanged": 0,
            "reshard_recomputes": 0,
        })
        # unified introspection tree: every subsystem's counter namespace
        # mounted under one surface (`coll` is process-wide, a thunk)
        self._metrics = MetricsTree(
            stages=self.engine.stats,
            shuffle=self.shuffle.stats,
            kernels=self.shuffle.kernels.stats,
            coll=comm_mod.comm_stats,
            elastic=self.elastic_stats,
        )
        # job-scheduler serialisation points (core/job.py): the base lock
        # covers the whole worker; gang-scheduled tasks instead hold one
        # GROUP lock each. All re-entrant so nested eager actions inside a
        # running native task execute inline.
        self._job_lock = threading.RLock()
        # id(ctx) → (ctx, lock, pinned); pinned entries (worker.groups()
        # splits) live forever, ad-hoc entries are evicted FIFO beyond the cap
        self._group_locks: "OrderedDict[int, tuple]" = OrderedDict()
        # n_groups → (base context the split was built from, groups): a
        # grow/shrink swaps _base_context, so a split of the old world is
        # rebuilt on next use instead of surviving the resize
        self._groups: dict[int, tuple] = {}
        self._groups_guard = threading.Lock()
        # serialises grow/shrink against each other (the drain handles jobs)
        self._resize_lock = threading.RLock()
        # executors reported lost and the cached nodes whose blocks a lost
        # executor takes with it (WeakSet: dropping every frame releases them)
        self.executor_blacklist: set[int] = set()
        self._cached_nodes = weakref.WeakSet()
        cluster.workers.append(self)

    # ------------------------------------------------------------------
    # communicator groups (MPI_Comm_split over the worker's ranks)
    # ------------------------------------------------------------------
    @property
    def context(self) -> IContext:
        """The worker's ACTIVE communicator: the base (world) context, or
        the group communicator installed by ``use_group`` on this thread."""
        return getattr(self._ctx_local, "ctx", None) or self._base_context

    def use_group(self, ctx: "IContext | None"):
        """Context manager binding this THREAD's active communicator."""
        import contextlib

        @contextlib.contextmanager
        def _bind():
            prev = getattr(self._ctx_local, "ctx", None)
            self._ctx_local.ctx = ctx
            try:
                yield ctx or self._base_context
            finally:
                self._ctx_local.ctx = prev

        return _bind()

    def groups(self, n_groups: int) -> "list[IContext]":
        """The worker's cached ``n_groups``-way split of its base ranks, so
        every job gang-scheduled at the same width shares one set of group
        communicators and one group lock per slice."""
        with self._groups_guard:
            entry = self._groups.get(n_groups)
            # revalidate against the CURRENT world: a resize swaps
            # _base_context, and a split of the old world would otherwise
            # keep handing out stale groups
            if entry is not None and entry[0] is not self._base_context:
                for g in entry[1]:
                    self._group_locks.pop(id(g), None)
                entry = None
            if entry is None:
                gs = self._base_context.split(n_groups)
                entry = self._groups[n_groups] = (self._base_context, gs)
                for g in gs:
                    self._group_locks[id(g)] = (g, threading.RLock(), True)
            gs = entry[1]
            lost = sorted({r for g in gs for r in g.group_ranks
                           if r in self.executor_blacklist})
            if lost:
                raise ValueError(
                    f"groups({n_groups}) spans blacklisted executors {lost} "
                    f"(lost containers); restore_executor() to re-admit them")
            return gs

    def group_lock(self, ctx: IContext) -> threading.RLock:
        """The job lock guarding a group communicator's ranks. An unknown
        (caller-built) group context gets its own lock on demand; such
        ad-hoc entries are evicted FIFO beyond ``_GROUP_LOCK_CAP``."""
        with self._groups_guard:
            entry = self._group_locks.get(id(ctx))
            if entry is None:
                entry = self._group_locks[id(ctx)] = (ctx, threading.RLock(), False)
                if len(self._group_locks) > self._GROUP_LOCK_CAP:
                    for key, (_c, _l, pinned) in list(self._group_locks.items()):
                        if not pinned:
                            del self._group_locks[key]
                            break
            return entry[1]

    # ------------------------------------------------------------------
    # elastic mesh: runtime grow/shrink
    # ------------------------------------------------------------------
    def _world_ranks(self) -> list:
        return list(self._base_context.ranks)

    def grow(self, n: int = 1) -> int:
        """Admit ``n`` executor ranks at runtime: in-flight tasks drain on
        the old communicator, the base context rebinds a world extended
        with ``n`` free rank slots, and cached partitions reshard
        incrementally. Returns the new world size."""
        if n < 1:
            raise ValueError(f"grow() needs n >= 1, got {n}")
        with self._resize_lock:
            cur = self._world_ranks()
            have = set(cur)
            pool = [r for r in range(self.cluster.slots) if r not in have]
            if len(pool) < n:
                raise ValueError(
                    f"grow({n}): only {len(pool)} free rank slot(s) beyond the "
                    f"current {len(cur)}-executor world")
            return self._resize(cur + pool[:n])

    def shrink(self, ranks) -> int:
        """Retire executor ranks at runtime: ``shrink(2)`` retires the two
        highest ranks, ``shrink([1, 3])`` retires exactly those ranks. At
        least one rank must survive. Cached blocks owned by retired ranks
        move onto the survivors (incremental reshard — pure data movement,
        no lineage recompute). Returns the new world size."""
        with self._resize_lock:
            cur = self._world_ranks()
            if isinstance(ranks, int):
                if ranks < 1:
                    raise ValueError(f"shrink() needs >= 1 rank, got {ranks}")
                ranks = range(len(cur) - ranks, len(cur))
            retire = sorted({int(r) for r in ranks})
            if not retire:
                raise ValueError("shrink() needs at least one rank")
            bad = [r for r in retire if not 0 <= r < len(cur)]
            if bad:
                raise ValueError(
                    f"shrink() ranks {bad} out of range for {len(cur)} executors")
            if len(retire) >= len(cur):
                raise ValueError(
                    f"shrink({retire}) would retire the whole {len(cur)}-rank "
                    f"world; at least one executor must survive")
            gone = set(retire)
            return self._resize([r for i, r in enumerate(cur) if i not in gone])

    def _resize(self, new_ranks: list) -> int:
        """Swap the base communicator onto ``new_ranks`` under a full drain:
        the worker job lock plus every pinned group lock (the ``groups()``
        splits gang tasks serialise on) are held, so in-flight tasks finish
        on the OLD communicator and later submissions bind the resized
        world via ``worker.context``. Ad-hoc caller-built groups are not
        drained; their tasks keep computing on their own (stale but intact)
        ranks. Call from a driver thread that holds no job locks."""
        old = self._base_context
        with self._groups_guard:
            drain = [lock for (_c, lock, pinned) in self._group_locks.values()
                     if pinned]
        held = []
        self._job_lock.acquire()
        held.append(self._job_lock)
        for lk in drain:
            lk.acquire()
            held.append(lk)
        try:
            old_ranks = self._world_ranks()
            old_world = frozenset(old_ranks)
            new_ctx = IContext(tuple(new_ranks), old.device, old.axis,
                               self.cluster.props, self)
            new_ctx._vars = dict(old._vars)
            self._base_context = new_ctx
            # the blacklist is position-indexed: re-key it by rank identity
            # (a blacklisted position whose rank was retired is simply gone)
            pos = {r: i for i, r in enumerate(new_ranks)}
            self.executor_blacklist = {
                pos[old_ranks[i]] for i in self.executor_blacklist
                if i < len(old_ranks) and old_ranks[i] in pos}
            # cached splits of the old world are stale; groups() also
            # revalidates by base identity, this just frees the locks now
            with self._groups_guard:
                for _base, gs in self._groups.values():
                    for g in gs:
                        self._group_locks.pop(id(g), None)
                self._groups.clear()
            from repro_torch.distributed.elastic import reshard_cached

            moves, kept, recomputes = reshard_cached(self, old_world, new_ctx)
            st = self.elastic_stats
            st["grows" if len(new_ranks) > len(old_ranks) else "shrinks"] += 1
            st["world_size"] = len(new_ranks)
            st["reshard_moves"] += moves
            st["reshard_unchanged"] += kept
            st["reshard_recomputes"] += recomputes
            return len(new_ranks)
        finally:
            for lk in reversed(held):
                lk.release()

    # ------------------------------------------------------------------
    # executor failure (paper §3.5: container loss + blacklist)
    # ------------------------------------------------------------------
    def _register_cached(self, node: TaskNode):
        """Track a node holding materialised blocks (persist / parallelize /
        checkpoint) so a simulated executor loss can take its block, and a
        resize can reshard it."""
        self._cached_nodes.add(node)

    def kill_executor(self, rank: int, blacklist: bool = True) -> int:
        """Simulate losing the container of executor ``rank``: every cached
        node of this worker loses its ``rank``-th block, and the rank is
        blacklisted so new communicator groups avoid it until
        ``restore_executor``. Returns the number of blocks lost."""
        killed = 0
        for node in list(self._cached_nodes):
            if (node.result is not None and rank < len(node.result)
                    and node.result[rank] is not None):
                DagEngine.kill_block(node, rank)
                killed += 1
        if blacklist:
            self.executor_blacklist.add(int(rank))
        return killed

    def restore_executor(self, rank: int):
        """Lift the blacklist for a recovered/replaced executor."""
        self.executor_blacklist.discard(int(rank))

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def explain(self, df: IDataFrame) -> str:
        """Physical plan of a frame's lineage — fused stages + boundaries,
        shuffle capacity annotations, shuffle telemetry."""
        return df.explain()

    def metrics(self, path: str | None = None) -> dict:
        """The worker's namespaced metrics tree: ``stages/`` (DagEngine),
        ``shuffle/`` (ShuffleManager), ``kernels/`` (kernel tier), ``coll/``
        (process-wide collective engine), ``elastic/`` (resizes). ``path``
        selects one subtree."""
        return self._metrics.snapshot(path)

    def mount_metrics(self, name: str, source) -> None:
        self._metrics.mount(name, source)

    def stage_stats(self) -> dict:
        """Deprecated facade over ``metrics("stages")``."""
        warn_deprecated("IWorker.stage_stats()", 'IWorker.metrics("stages")')
        return self._metrics.snapshot("stages")

    def shuffle_stats(self) -> dict:
        """Deprecated facade over the ``shuffle`` + ``kernels`` + ``coll``
        metrics subtrees, merged flat."""
        warn_deprecated("IWorker.shuffle_stats()",
                        'IWorker.metrics("shuffle"/"kernels"/"coll")')
        return {**self._metrics.snapshot("shuffle"),
                **self._metrics.snapshot("kernels"),
                **self._metrics.snapshot("coll")}

    # ------------------------------------------------------------------
    # data ingestion (driver communicator)
    # ------------------------------------------------------------------
    @property
    def executors(self) -> int:
        return self.context.executors

    def _put(self, x):
        return x.to(self.device)

    def parallelize(self, rows, blocks: int = 1) -> IDataFrame:
        p = self.executors
        ranks = self.context.ranks
        if blocks <= 1:
            blk = [from_host(rows, p, self.device, ranks)]
        else:
            per = (len(rows) + blocks - 1) // blocks
            blk = [
                from_host(rows[i * per: (i + 1) * per], p, self.device, ranks)
                for i in range(blocks)
                if len(rows[i * per: (i + 1) * per])
            ]
        node = TaskNode("parallelize", [], fn=lambda _: blk, narrow=False)
        node.result = blk
        node.cached = True
        self._register_cached(node)
        # structural source signature: re-parallelizing same-shaped data maps
        # to the same lineage signature (shuffle capacity memory)
        node.sig = ("src", tuple(block_aval(b) for b in blk))
        return IDataFrame(self, node)

    def text_file(self, path: str, as_tokens: bool = False, blocks: int = 1):
        """Read a text file. Rows are (line-hash, length) pairs unless
        ``as_tokens`` — then the host tokenizer maps words to ids and rows
        are token ids."""
        with open(path) as f:
            lines = [l.rstrip("\n") for l in f]
        if as_tokens:
            vocab: dict[str, int] = {}
            toks = []
            for line in lines:
                for w in line.split():
                    toks.append(vocab.setdefault(w, len(vocab)))
            self._text_vocab = vocab
            return self.parallelize(np.asarray(toks, np.int32), blocks)
        self._text_lines = lines
        rows = np.asarray([[hash(l) & 0x7FFFFFFF, len(l)] for l in lines], np.int32)
        return self.parallelize(rows, blocks)

    textFile = text_file

    def partition_json_file(self, path: str) -> IDataFrame:
        import json

        with open(path) as f:
            data = json.load(f)
        return self.parallelize(np.asarray(data))

    partitionJsonFile = partition_json_file

    # ------------------------------------------------------------------
    # inter-worker communicator (paper Fig. 4: importData)
    # ------------------------------------------------------------------
    def import_data(self, df: IDataFrame) -> IDataFrame:
        src_worker = df.worker

        def fn(parent_results):
            faults.check("reshard", kind="importData", src=src_worker.name,
                         dst=self.name)
            if self.mode == "spark" or src_worker.mode == "spark":
                # the paper's pipe: serialize → host → deserialize
                return [self._from_host(
                    pickle.loads(pickle.dumps(tree.map(_host, b.data))), _host(b.valid))
                    for b in parent_results[0]]
            # on-device reshard: the inter-worker communicator
            return [place_block(b, self.context) for b in parent_results[0]]

        node = TaskNode("importData", [df.node], fn=fn, narrow=False)
        return IDataFrame(self, node)

    importData = import_data

    # ------------------------------------------------------------------
    # native SPMD apps (paper §5)
    # ------------------------------------------------------------------
    def load_library(self, path_or_module: str) -> list[str]:
        names = load_library(path_or_module)
        self._libraries.extend(names)
        return names

    loadLibrary = load_library

    def _resolve_app(self, fn_name, params):
        """Resolve (app callable, display name, merged params, sig token)
        from a registry name, a callable, or an ISource with addParams."""
        if isinstance(fn_name, ISource):
            src, params = fn_name.fn, {**fn_name.params, **params}
        else:
            src = fn_name
        app = get_app(src) if isinstance(src, str) else src
        name = src if isinstance(src, str) else getattr(src, "__name__", "app")
        isrc = ISource(src)
        isrc.params = dict(params)
        return app, name, params, isrc.token()

    @staticmethod
    def _native_args(ctx, parent_results):
        """Materialise a native app's data args on the app's communicator."""
        if not parent_results:
            return ()
        faults.check("reshard", kind="native")
        b = place_block(concat_blocks(parent_results[0]), ctx)
        return (b.data, b.valid)

    def void_call_async(self, fn_name, df: IDataFrame | None = None, job=None,
                        **params):
        """Async voidCall: the app runs as a native TaskNode inside the job
        DAG. Returns an IFuture resolving to the app's return value.
        ``job`` is reserved for the IJob here; an app parameter literally
        named "job" must go through ``ISource.add_param``."""
        return self._void_call_task(fn_name, df, params, job)

    def _void_call_task(self, fn_name, df, params: dict, job):
        app, name, params, tok = self._resolve_app(fn_name, params)
        parents = [df.node] if df is not None else []
        worker = self
        out_cell: dict = {}

        def fn(parent_results):
            ctx = worker.context.bind(params)  # execution-time binding
            out_cell["value"] = app(ctx, *worker._native_args(ctx, parent_results))
            return []  # void: no blocks enter the lineage

        node = TaskNode(f"voidCall:{name}", parents, fn=fn, narrow=False)
        node.task_kind = "native"
        node.owner = self
        node.sig = ("native", "voidCall", tok, *(node_sig(p) for p in parents))
        frame = IDataFrame(self, node)

        def task_fn(memo):
            worker.engine.evaluate(node, memo=memo)
            return out_cell.get("value")

        return frame._submit("voidCall", task_fn=task_fn, job=job)

    def void_call(self, fn_name, df: IDataFrame | None = None, **params):
        """Run a native app for effect (paper's voidCall) — facade over the
        async path."""
        return self._void_call_task(fn_name, df, params, None).result()

    def call(self, fn_name, df: IDataFrame | None = None, **params) -> IDataFrame:
        """Run a native app returning rows → IDataFrame (paper's call).

        The child IContext is bound when the task EXECUTES, and the (app,
        params) token is part of ``node.sig`` so downstream plan/capacity
        caches key on the actual call."""
        app, name, params, tok = self._resolve_app(fn_name, params)
        parents = [df.node] if df is not None else []
        worker = self

        def fn(parent_results):
            ctx = worker.context.bind(params)  # execution-time binding
            out = app(ctx, *worker._native_args(ctx, parent_results))
            if comm_mod.is_handle(out):
                # app handed back an in-flight result: chain the Block
                # adaptation onto the handle and let the engine await it
                return out.chain(
                    lambda v: [v] if isinstance(v, Block) else [Block(*v)])
            if isinstance(out, Block):
                return [out]
            data, valid = out
            return [Block(data, valid)]

        node = TaskNode(f"call:{name}", parents, fn=fn, narrow=False)
        node.task_kind = "native"
        node.owner = self
        node.sig = ("native", "call", tok, *(node_sig(p) for p in parents))
        return IDataFrame(self, node)

    def call_partitions(self, fn_name, df: IDataFrame, **params) -> IDataFrame:
        """Partition-preserving native call: the app runs once per block
        with the worker communicator. The node is narrow with block-wise
        lineage (only a lost block re-runs the app)."""
        app, name, params, tok = self._resolve_app(fn_name, params)
        worker = self

        def block_fn(parent_blocks):
            ctx = worker.context.bind(params)  # execution-time binding
            b = parent_blocks[0]
            out = app(ctx, b.data, b.valid)
            if comm_mod.is_handle(out):
                out = out.wait()  # block-wise lineage is the sync point here
            if isinstance(out, Block):
                return out
            data, valid = out
            return Block(data, valid)

        node = TaskNode(
            f"callPartitions:{name}", [df.node], block_fn=block_fn, narrow=True
        )
        node.task_kind = "native"
        node.owner = self
        node.sig = ("native", "callPartitions", tok, node_sig(df.node))
        return IDataFrame(self, node)

    voidCall = void_call
    voidCallAsync = void_call_async
    callPartitions = call_partitions

    # ------------------------------------------------------------------
    # spark mode: the driver-pipe baseline (paper §2.1: system pipes
    # outside the JVM). Reached only under ignis.mode=spark, never in
    # ignis mode: it is the baseline the paper measures, not a fallback.
    # ------------------------------------------------------------------
    # PySpark serializes RDD elements through the JVM↔worker pipe in pickle
    # batches (default batchSize=1024) — per-ELEMENT object serialization,
    # not one bulk buffer. That is the cost the paper measures (§2.1, §6.2).
    _PIPE_BATCH = 1024

    def _from_host(self, data, valid) -> Block:
        """Host arrays → a Block of fresh tensors on the worker's device."""
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, copy=True)

        return Block(tree.map(put, data), put(valid))

    def _pipe_block(self, b: Block) -> Block:
        """Charge the pipe cost: device→host, per-element pickle of every
        valid row in PySpark-sized batches, host→device. The data itself is
        returned unchanged — this models serialization cost, not semantics."""
        data = tree.map(_host, b.data)
        valid = _host(b.valid)
        leaves = tree.leaves(data)
        idx = np.nonzero(valid)[0]
        for lo in range(0, len(idx), self._PIPE_BATCH):
            sel = idx[lo: lo + self._PIPE_BATCH]
            batch = [[np.asarray(l[i]) for l in leaves] for i in sel]
            pickle.loads(pickle.dumps(batch))  # the JVM↔worker pipe
        return self._from_host(data, valid)

    def _pipe_wrap(self, block_fn):
        def wrapped(parent_blocks):
            return self._pipe_block(block_fn(parent_blocks))

        return wrapped

    def _pipe_wrap_wide(self, node_fn):
        """Spark's shuffle path: results serialize through the host (JVM)."""

        def wrapped(parent_results):
            return [self._pipe_block(b) for b in node_fn(parent_results)]

        return wrapped


def _host(t: torch.Tensor) -> np.ndarray:
    """Device → host copy of one leaf (the pipe's first leg)."""
    return t.cpu().numpy()
