"""Ignis / ICluster / IWorker — the job hierarchy (paper §3.2, Fig. 2).

A *Cluster* owns one torch device and ``ignis.executor.instances`` virtual
executor ranks on it (its "containers"); *Workers* are programming-model
execution contexts on those ranks: dataflow workers and SPMD workers that
interoperate through ``importData`` (the inter-worker communicator: moving a
block between devices, a no-op on the same device).

The cluster's device comes from ``ignis.device`` (``cuda`` by default). A
cluster asked for ``cuda`` where no card is visible raises: it never carries
on quietly on the CPU. Tests pass ``ignis.device=cpu``.
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
from repro_torch.core.metrics import MetricsTree, warn_deprecated
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
    """A group of executor containers: ``p`` virtual ranks on one device."""

    def __init__(self, props: Optional[IProperties] = None):
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
        # unified introspection tree: every subsystem's counter namespace
        # mounted under one surface (`coll` is process-wide, a thunk)
        self._metrics = MetricsTree(
            stages=self.engine.stats,
            shuffle=self.shuffle.stats,
            kernels=self.shuffle.kernels.stats,
            coll=comm_mod.comm_stats,
        )
        # job-scheduler serialisation points (core/job.py): the base lock
        # covers the whole worker; gang-scheduled tasks instead hold one
        # GROUP lock each. All re-entrant so nested eager actions inside a
        # running native task execute inline.
        self._job_lock = threading.RLock()
        # id(ctx) → (ctx, lock, pinned); pinned entries (worker.groups()
        # splits) live forever, ad-hoc entries are evicted FIFO beyond the cap
        self._group_locks: "OrderedDict[int, tuple]" = OrderedDict()
        self._groups: dict[int, list] = {}
        self._groups_guard = threading.Lock()
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
            gs = self._groups.get(n_groups)
            if gs is None:
                gs = self._groups[n_groups] = self._base_context.split(n_groups)
                for g in gs:
                    self._group_locks[id(g)] = (g, threading.RLock(), True)
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
    # executor failure (paper §3.5: container loss + blacklist)
    # ------------------------------------------------------------------
    def _register_cached(self, node: TaskNode):
        """Track a node holding materialised blocks (persist / parallelize)
        so a simulated executor loss can take its block."""
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
        (process-wide collective engine). ``path`` selects one subtree."""
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
        if blocks <= 1:
            blk = [from_host(rows, p, self.device)]
        else:
            per = (len(rows) + blocks - 1) // blocks
            blk = [
                from_host(rows[i * per: (i + 1) * per], p, self.device)
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
            return [place_block(b, self.device) for b in parent_results[0]]

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
        b = place_block(concat_blocks(parent_results[0]), ctx.device)
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
