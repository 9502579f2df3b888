"""IDataFrame — the Spark-inspired lazy dataflow API (paper §4, Table 1).

Transformations register TaskNodes (lazy); actions trigger DAG evaluation.
All wide operators execute as collectives over the worker's ranks ("ignis"
mode) or additionally pay the driver pipe ("spark" mode: every result goes
device → host → per-element pickle → device, and nothing fuses).

Row functions are torch row functions: Python callables, ``ISource``
wrappers or text lambdas (paper §4.2) — resolved by ``textlambda.resolve``.

Wide (shuffle-backed) operators route through the worker's adaptive shuffle
engine (``shuffle_plan.ShuffleManager``, DESIGN.md §6): each registers a
structural lineage signature so capacities are remembered across actions and
re-built lineages. Per-operator semantics (wide/narrow classification,
fusability, capacity/padding behavior) are documented in
docs/dataframe.md.
"""
from __future__ import annotations

import json as _json

import numpy as np
import torch

from repro_torch.core import comm, tree
from repro_torch.core import executor as ex
from repro_torch.core import shuffle as sh
from repro_torch.core.dag import TaskNode, node_sig
from repro_torch.core.partition import Block, concat_blocks, pad_to, split_block, to_host
from repro_torch.core.shuffle_plan import _static_token, fn_token
from repro_torch.core.textlambda import resolve


def _to_numpy(x):
    """Host copy of a tree of tensors (the driver boundary)."""
    return tree.map(lambda t: t.cpu().numpy() if isinstance(t, torch.Tensor) else t, x)


def _pack_default(row):
    """Default sortable packing of a row (distinct/sort keys).

    Scalars pass through; (a, b) int pairs pack to (a<<16)|b — fine for the
    graph demos (vertex ids < 2^16); users pass key_fn for wider domains.
    """
    if isinstance(row, tuple) and len(row) == 2:
        return (row[0].to(torch.int32) << 16) | (row[1].to(torch.int32) & 0xFFFF)
    if isinstance(row, dict) and set(row) == {"key", "value"}:
        return row["key"]
    return row


class IDataFrame:
    def __init__(self, worker, node: TaskNode):
        self.worker = worker
        self.node = node
        if node.owner is None:
            # job-scheduler routing (core/job.py): edges between differently-
            # owned nodes are cross-worker task boundaries
            node.owner = worker

    # ------------------------------------------------------------------
    # plumbing
    # ------------------------------------------------------------------
    @property
    def _ctx(self):
        return self.worker.context

    @property
    def _engine(self):
        return self.worker.engine

    def _narrow(self, op: str, kernel, key: tuple = (), fusable: bool = True) -> "IDataFrame":
        """Register a narrow op from a Block → Block kernel.

        The kernel doubles as the node's ``block_fn`` (unfused / repair path)
        and, when ``fusable``, as its ``fuse_fn`` — the planner composes
        consecutive fuse_fns into one stage (DESIGN.md §5). ``key``
        extends the op name into the plan-cache signature. In spark mode every
        op pays the driver pipe, so nothing can fuse across it."""
        def block_fn(ps, _k=kernel):
            return _k(ps[0])

        fuse_fn = kernel if fusable else None
        # fn-valued key parts are tokenised structurally (code + closure
        # cells), so a re-built identical lineage maps to the same fuse_key →
        # same plan-cache entry and the same shuffle capacity-memory slot.
        tkey = tuple(fn_token(k) if callable(k) else k for k in key)
        fuse_key = (op, *tkey) if fuse_fn is not None else None
        if self.worker.mode == "spark":
            block_fn = self.worker._pipe_wrap(block_fn)
            fuse_fn = fuse_key = None
        node = TaskNode(op, [self.node], block_fn=block_fn, narrow=True,
                        fuse_fn=fuse_fn, fuse_key=fuse_key)
        node.sig = ("n", fuse_key if fuse_key is not None else (op, node.id),
                    node_sig(self.node))
        return IDataFrame(self.worker, node)

    def _wide(self, op: str, fn, extra_parents=(), key: tuple = (),
              shuffle: bool = False, needs_sig: bool = False) -> "IDataFrame":
        """Register a wide op. ``key`` extends the structural signature;
        ``needs_sig=True`` ops receive ``fn(parent_results, sig)`` so they can
        consult the shuffle engine's capacity memory; ``shuffle=True`` marks
        the node for explain()'s capacity annotations."""
        parents = [self.node, *extra_parents]
        tkey = tuple(fn_token(k) if callable(k) else k for k in key)
        sig = ("w", op, *tkey, *(node_sig(p) for p in parents))
        if needs_sig:
            inner = fn
            fn = lambda prs, _inner=inner, _sig=sig: _inner(prs, _sig)  # noqa: E731
        if self.worker.mode == "spark":
            fn = self.worker._pipe_wrap_wide(fn)
        node = TaskNode(op, parents, fn=fn, narrow=False)
        node.sig = sig
        if shuffle:
            node.shuffle_sig = sig
        return IDataFrame(self.worker, node)

    def _blocks(self) -> list[Block]:
        return self._engine.evaluate(self.node)

    def _merged(self) -> Block:
        return concat_blocks(self._blocks())

    # ------------------------------------------------------------------
    # conversion transformations (narrow)
    # ------------------------------------------------------------------
    def map(self, fn) -> "IDataFrame":
        fn = resolve(fn)
        return self._narrow("map", ex.map_kernel(fn), key=(fn,))

    def filter(self, fn) -> "IDataFrame":
        fn = resolve(fn)
        return self._narrow("filter", ex.filter_kernel(fn), key=(fn,))

    def flatmap(self, fn, fanout: int) -> "IDataFrame":
        fn = resolve(fn)
        return self._narrow("flatmap", ex.flatmap_kernel(fn, fanout), key=(fn, fanout))

    def map_partitions(self, fn) -> "IDataFrame":
        # fn sees raw block data and may do host-side work → opaque to fusion
        fn = resolve(fn)
        return self._narrow(
            "mapPartitions",
            lambda b: ex.map_partitions_block(b, fn),
            fusable=False,
        )

    def key_by(self, fn) -> "IDataFrame":
        fn = resolve(fn)
        return self._narrow("keyBy", ex.key_by_kernel(fn), key=(fn,))

    def map_values(self, fn) -> "IDataFrame":
        fn = resolve(fn)
        return self._narrow("mapValues", ex.map_values_kernel(fn), key=(fn,))

    def keys(self) -> "IDataFrame":
        return self._narrow("keys", ex.keys_block)

    def values(self) -> "IDataFrame":
        return self._narrow("values", ex.values_block)

    def sample(self, fraction: float, seed: int = 0) -> "IDataFrame":
        return self._narrow("sample", ex.sample_kernel(fraction, seed),
                            key=(fraction, seed))

    def sample_by_key(self, fractions: dict, seed: int = 0) -> "IDataFrame":
        """Stratified sampling on a KV frame: per-key keep fractions."""
        items = sorted((int(k), float(v)) for k, v in fractions.items())

        def kernel(b):
            dev = b.device
            keys_arr = torch.tensor([k for k, _ in items], dtype=torch.int32, device=dev)
            frac_arr = torch.tensor([v for _, v in items], dtype=torch.float32,
                                    device=dev)
            k = b.data["key"].to(torch.int32)
            idx = torch.searchsorted(keys_arr, k)
            idxc = torch.clamp(idx, 0, keys_arr.shape[0] - 1)
            f = torch.where(keys_arr[idxc] == k, frac_arr[idxc], 0.0)
            g = torch.Generator(device=dev)
            g.manual_seed(seed + b.capacity)
            u = torch.rand((b.capacity,), generator=g, device=dev)
            return Block(b.data, b.valid & (u < f))

        return self._narrow("sampleByKey", kernel, key=(tuple(items), seed))

    def take_sample(self, n: int, seed: int = 0) -> list:
        """Action: uniform sample of n valid rows (without replacement)."""
        rows = self.collect()
        import random

        rng = random.Random(seed)
        return rng.sample(rows, min(n, len(rows)))

    def foreach_async(self, fn, job=None, group=None):
        fn = resolve(fn)

        def act(blocks):
            for b in blocks:
                for row in to_host(b):
                    fn(row)

        return self._submit("foreach", act, job=job, group=group)

    def foreach(self, fn):
        """Action: apply a host-side fn to every valid row (paper's Void fns)."""
        return self.foreach_async(fn).result()

    sampleByKey = sample_by_key
    takeSample = take_sample

    # camelCase aliases (paper API)
    flatMap = flatmap
    keyBy = key_by
    mapValues = map_values
    mapPartitions = map_partitions

    # ------------------------------------------------------------------
    # SQL-ish / set ops
    # ------------------------------------------------------------------
    def union(self, other: "IDataFrame") -> "IDataFrame":
        def fn(parent_results):
            return parent_results[0] + parent_results[1]

        return self._wide("union", fn, extra_parents=[other.node])

    def distinct(self, key_fn=None) -> "IDataFrame":
        key_fn = resolve(key_fn) if key_fn else _pack_default
        worker = self.worker

        def fn(parent_results, sig):
            b = concat_blocks(parent_results[0])
            return [worker.shuffle.distinct(sig, b, key_fn)]

        return self._wide("distinct", fn, key=(key_fn,), shuffle=True,
                          needs_sig=True)

    def join(self, other: "IDataFrame", max_matches: int | None = None) -> "IDataFrame":
        """Inner join of two KV frames → rows (key, (lvalue, rvalue))."""
        M = max_matches or self.worker.join_max_matches
        worker = self.worker

        def fn(parent_results, sig):
            lb = concat_blocks(parent_results[0])
            rb = concat_blocks(parent_results[1])
            return [worker.shuffle.join(sig, lb, rb, M)]

        return self._wide("join", fn, extra_parents=[other.node], key=(M,),
                          shuffle=True, needs_sig=True)

    # ------------------------------------------------------------------
    # sort / group / reduceByKey
    # ------------------------------------------------------------------
    def sort_by(self, key_fn, ascending: bool = True) -> "IDataFrame":
        key_fn = resolve(key_fn)
        worker = self.worker

        def fn(parent_results, sig):
            b = concat_blocks(parent_results[0])
            return [worker.shuffle.sort(sig, b, key_fn, ascending)]

        return self._wide("sortBy", fn, key=(key_fn, ascending), shuffle=True,
                          needs_sig=True)

    def sort(self, ascending: bool = True) -> "IDataFrame":
        return self.sort_by(lambda r: r, ascending)

    def sort_by_key(self, ascending: bool = True) -> "IDataFrame":
        return self.sort_by(lambda r: r["key"], ascending)

    def reduce_by_key(self, fn, identity=0) -> "IDataFrame":
        """Merge values per key with ``fn`` (fused into the sort stage).

        A builtin ``fn`` (traces to one add/maximum/minimum over a single
        f32/i32 leaf) rides the kernel tier where the registry selects it,
        bit-identically to the plain path — the chosen tier shows up in
        ``df.explain()``."""
        fn = resolve(fn)
        worker = self.worker

        def node_fn(parent_results, sig):
            b = concat_blocks(parent_results[0])
            return [worker.shuffle.reduce_by_key(sig, b, fn, identity)]

        return self._wide("reduceByKey", node_fn, key=(fn, _static_token(identity)),
                          shuffle=True, needs_sig=True)

    def aggregate_by_key(self, zero, seq_fn, comb_fn) -> "IDataFrame":
        seq_fn, comb_fn = resolve(seq_fn), resolve(comb_fn)
        mapped = self.map_values(lambda v: seq_fn(zero, v))
        return mapped.reduce_by_key(comb_fn, zero)

    def group_by_key(self, group_capacity: int = 8) -> "IDataFrame":
        """Rows (key, (values[G], count)) at segment heads; G-bounded groups."""
        worker = self.worker
        G = group_capacity

        def node_fn(parent_results, sig):
            b = concat_blocks(parent_results[0])
            return [worker.shuffle.group_by_key(sig, b, G)]

        return self._wide("groupByKey", node_fn, key=(G,), shuffle=True,
                          needs_sig=True)

    def group_by(self, key_fn, group_capacity: int = 8) -> "IDataFrame":
        return self.key_by(key_fn).group_by_key(group_capacity)

    # camelCase aliases
    sortBy = sort_by
    sortByKey = sort_by_key
    reduceByKey = reduce_by_key
    aggregateByKey = aggregate_by_key
    groupByKey = group_by_key
    groupBy = group_by

    # ------------------------------------------------------------------
    # balancing / persistence
    # ------------------------------------------------------------------
    def repartition(self, k: int) -> "IDataFrame":
        p = self._ctx.executors

        def fn(parent_results):
            return split_block(concat_blocks(parent_results[0]), k, p)

        return self._wide("repartition", fn)

    def partition_by(self, key_fn=None) -> "IDataFrame":
        key_fn = resolve(key_fn) if key_fn else _pack_default
        worker = self.worker

        def fn(parent_results, sig):
            b = concat_blocks(parent_results[0])
            return [worker.shuffle.partition_by(sig, b, key_fn)]

        return self._wide("partitionBy", fn, key=(key_fn,), shuffle=True,
                          needs_sig=True)

    partitionBy = partition_by

    def compact(self) -> "IDataFrame":
        """Compact away invalid rows (lazy node).

        Fixed shapes mean filters/joins/distinct leave masked holes and
        capacity padding that compound across iterative fixed-point loops.
        compact() is the materialisation Spark performs implicitly — use it
        after distinct() in loops, or before a join of a reduced frame. The
        reference round-trips the rows through the host; here the valid rows
        are gathered on the device, in the same order and padding, so the
        result is the same block without the host copy."""
        worker = self.worker

        def fn(parent_results):
            b = concat_blocks(parent_results[0])
            idx = torch.nonzero(b.valid).flatten()
            n = int(idx.shape[0])
            if n == 0:  # nothing valid: keep (tiny) all-invalid parent block
                return parent_results[0][:1]
            p = worker.executors
            cap = max(pad_to(n, p), p)

            def take(x):
                out = x.new_zeros((cap, *x.shape[1:]))
                out[:n] = x[idx]
                return out

            valid = torch.arange(cap, device=b.device) < n
            return [Block(tree.map(take, b.data), valid)]

        return self._wide("compact", fn)

    def persist(self) -> "IDataFrame":
        self.node.cached = True
        self.worker._register_cached(self.node)
        return self

    cache = persist

    def unpersist(self) -> "IDataFrame":
        """Drop the node's materialised blocks and stop caching: the next
        action recomputes from lineage. Scope note (docs/fault_tolerance.md):
        this evicts the NODE-level cache; an explicit long-lived ``IJob``
        additionally memoises evaluated subgraphs for reuse *within* that
        job — ``job.release()`` is the eviction point for that layer."""
        self.node.cached = False
        self.node.result = None
        return self

    uncache = unpersist

    def checkpoint(self, ckpt_dir: str) -> "IDataFrame":
        """Materialise this frame, persist its blocks through the checkpoint
        subsystem (``repro_torch.checkpoint``: manifest + content hashes),
        and TRUNCATE the lineage here: the node's parents are unlinked and
        its repair path restores lost blocks from the checkpoint —
        block-wise, integrity-verified — instead of recomputing ancestors
        (docs/fault_tolerance.md). Spark's ``checkpoint()`` semantic with
        per-block restore granularity; the step is keyed by the node id and
        kept forever (``keep=0``), so give each frame its own directory.
        Restored blocks land on the worker's device, committed to its
        active communicator."""
        from repro_torch import checkpoint as ck

        node = self.node
        worker = self.worker
        blocks = self._blocks()
        step = node.id
        ck.save(ckpt_dir, step,
                {f"b{i:05d}": {"data": b.data, "valid": b.valid}
                 for i, b in enumerate(blocks)},
                keep=0)
        metas = [
            tree.map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"),
                     {"data": b.data, "valid": b.valid})
            for b in blocks
        ]

        def _load(i: int) -> Block:
            key = f"b{i:05d}"
            t = ck.restore(ckpt_dir, step, {key: metas[i]}, worker.device)[key]
            return Block(t["data"], t["valid"], tuple(worker.context.ranks))

        node.op = f"checkpoint({node.op})"
        node.parents = []
        node.narrow = False
        node.fn = lambda _parents, _n=len(blocks): [_load(i) for i in range(_n)]
        node.block_fn = node.fuse_fn = node.fuse_key = None
        node.restore_fn = _load
        node.cached = True
        node.result = blocks
        node.sig = ("ckpt", ckpt_dir, step)
        node.shuffle_sig = None
        worker._register_cached(node)
        return self

    def explain(self) -> str:
        """Physical plan for this frame's lineage: which narrow ops the
        planner fuses into single-dispatch stages (DESIGN.md §5), wide nodes
        annotated with their shuffle capacity state and — when the kernel
        tier ran them — the kernel selection (``kernel=segment_reduce[...]
        op=sum block=128``, docs/kernels.md), plus the shuffle engine's
        telemetry summary (DESIGN.md §6) and kernel-registry counters."""
        mgr = getattr(self.worker, "shuffle", None)
        plan = self._engine.explain(self.node,
                                    annotate=mgr.annotate if mgr else None)
        return plan + ("\n" + mgr.summary() if mgr else "")

    # ------------------------------------------------------------------
    # actions — lazy job submission + eager facades
    #
    # Every action has an ``*_async`` twin returning an ``IFuture``: the
    # lineage is handed to the job scheduler (core/job.py), which cuts it
    # into per-worker tasks (native calls and importData reshards become
    # their own task nodes) and overlaps independent branches. The eager
    # form is a thin facade: ``df.count()`` IS ``df.count_async().result()``
    # (docs/driver.md). Pass ``job=`` to group many submissions — possibly
    # across workers and frames — into one scheduled job DAG.
    # ------------------------------------------------------------------
    def _submit(self, name: str, blocks_fn=None, task_fn=None, job=None,
                group=None):
        from repro_torch.core.job import IJob

        if job is None:
            job = IJob(f"{name}@{self.worker.name}")
        return job.submit_action(self, name, blocks_fn=blocks_fn, task_fn=task_fn,
                                 group=group)

    def count_async(self, job=None, group=None):
        # the per-block counts ride a nonblocking handle: the task fn only
        # DISPATCHES the reads, and the scheduler awaits the handle after
        # releasing the worker's job lock (core/job.py _settle) — so the
        # next task's tracing/planning overlaps this one's in-flight device
        # work instead of queueing behind a blocking device_get
        def act(blocks):
            counts = [ex.count_block(b) for b in blocks]
            return comm.CollHandle(
                "action.count", None, counts,
                transform=lambda cs: sum(int(c) for c in cs))

        return self._submit("count", act, job=job, group=group)

    def count(self) -> int:
        return self.count_async().result()

    def reduce_async(self, fn, identity=0, job=None, group=None):
        fn = resolve(fn)

        def act(blocks):
            b = concat_blocks(blocks)
            vfn = lambda a, c: tree.map(fn, a, c)  # noqa: E731
            out = ex.pairwise_reduce(b.data, b.valid, vfn, identity)
            return comm.CollHandle("action.reduce", None, out,
                                   transform=_to_numpy)

        return self._submit("reduce", act, job=job, group=group)

    def reduce(self, fn, identity=0):
        return self.reduce_async(fn, identity).result()

    tree_reduce = reduce
    treeReduce = reduce

    def aggregate_async(self, zero, seq_fn, comb_fn, job=None):
        seq_fn, comb_fn = resolve(seq_fn), resolve(comb_fn)
        return self.map(lambda r: seq_fn(zero, r)).reduce_async(comb_fn, zero, job=job)

    def aggregate(self, zero, seq_fn, comb_fn):
        return self.aggregate_async(zero, seq_fn, comb_fn).result()

    treeAggregate = aggregate

    def fold_async(self, zero, fn, job=None):
        return self.map(lambda r: r).reduce_async(fn, zero, job=job)

    def fold(self, zero, fn):
        return self.fold_async(zero, fn).result()

    def max_async(self, key_fn=None, job=None):
        return self._submit(
            "max", lambda blocks: self._extreme_of(blocks, key_fn, True), job=job
        )

    def max(self, key_fn=None):
        """Without key_fn: elementwise tree-max of valid rows. With key_fn:
        the ROW maximising key_fn(row) (Spark's max(key=...) — argmax)."""
        return self.max_async(key_fn).result()

    def min_async(self, key_fn=None, job=None):
        return self._submit(
            "min", lambda blocks: self._extreme_of(blocks, key_fn, False), job=job
        )

    def min(self, key_fn=None):
        """Without key_fn: elementwise tree-min. With key_fn: the row
        minimising key_fn(row) (argmin)."""
        return self.min_async(key_fn).result()

    def _extreme_of(self, blocks, key_fn, largest: bool):
        b = concat_blocks(blocks)
        if key_fn is None:
            op = torch.maximum if largest else torch.minimum
            sent = sh._sentinel_low if largest else sh._sentinel
            ident = tree.map(lambda x: sent(x.dtype), b.data)
            vfn = lambda a, c: tree.map(op, a, c)  # noqa: E731
            return _to_numpy(ex.pairwise_reduce(b.data, b.valid, vfn, ident))
        key_fn = resolve(key_fn)
        keys = ex._vmapped(key_fn)(b.data)
        sent = (sh._sentinel_low if largest else sh._sentinel)(keys.dtype)
        masked = torch.where(b.valid, keys, sent)
        i = int(torch.argmax(masked) if largest else torch.argmin(masked))
        if not bool(b.valid[i]):
            # a valid row tying the sentinel can shadow the winner; fall back
            # to the host (also the empty-frame path)
            rows = [r for blk in blocks for r in to_host(blk)]
            if not rows:
                raise ValueError("max()/min() with key_fn on an empty dataframe")
            pick = max if largest else min
            return pick(rows, key=lambda r: float(np.asarray(key_fn(r))))
        return _to_numpy(tree.map(lambda x: x[i], b.data))

    def collect_async(self, job=None, group=None):
        def act(blocks):
            def tx(_ready):
                out = []
                for b in blocks:
                    out.extend(to_host(b))
                return out

            return comm.CollHandle(
                "action.collect", None,
                [(b.data, b.valid) for b in blocks], transform=tx)

        return self._submit("collect", act, job=job, group=group)

    def collect(self) -> list:
        return self.collect_async().result()

    def take_async(self, k: int, job=None, group=None):
        """Early-exit take: blocks materialise one at a time through the
        engine's lazy block iterator and evaluation stops as soon as ``k``
        valid rows exist — a 100-block lineage pays for one block when the
        first block satisfies the request."""
        worker, node = self.worker, self.node

        def run(memo):
            out = []
            for b in worker.engine.evaluate_blocks_iter(node, memo=memo):
                out.extend(to_host(b))
                if len(out) >= k:
                    break
            return out[:k]

        return self._submit("take", task_fn=run, job=job, group=group)

    def take(self, k: int) -> list:
        return self.take_async(k).result()

    def top_async(self, k: int, key_fn=None, job=None):
        key_fn = resolve(key_fn) if key_fn else (lambda r: r)
        return self.sort_by(key_fn, ascending=False).take_async(k, job=job)

    def top(self, k: int, key_fn=None) -> list:
        return self.top_async(k, key_fn).result()

    @staticmethod
    def _kv_dict(blocks) -> dict:
        rows = [r for b in blocks for r in to_host(b)]
        return {int(np.asarray(r["key"])): int(np.asarray(r["value"])) for r in rows}

    def count_by_key_async(self, job=None):
        ones = self.map_values(lambda v: 1)
        red = ones.reduce_by_key(lambda a, b: a + b, 0)
        return red._submit("countByKey", self._kv_dict, job=job)

    def count_by_key(self) -> dict:
        return self.count_by_key_async().result()

    def count_by_value_async(self, job=None):
        kv = self.map(lambda r: {"key": r, "value": 1})
        red = kv.reduce_by_key(lambda a, b: a + b, 0)
        return red._submit("countByValue", self._kv_dict, job=job)

    def count_by_value(self) -> dict:
        return self.count_by_value_async().result()

    countByKey = count_by_key
    countByValue = count_by_value

    # ------------------------------------------------------------------
    # I/O
    # ------------------------------------------------------------------
    def save_as_text_file(self, path: str):
        with open(path, "w") as f:
            for row in self.collect():
                f.write(f"{_row_repr(row)}\n")

    def save_as_json_file(self, path: str):
        with open(path, "w") as f:
            _json.dump([_row_json(r) for r in self.collect()], f)

    def save_as_object_file(self, path: str):
        np.save(path, np.asarray(self.collect(), dtype=object), allow_pickle=True)

    saveAsTextFile = save_as_text_file
    saveAsJsonFile = save_as_json_file
    saveAsObjectFile = save_as_object_file


def _row_repr(row):
    if isinstance(row, dict):
        return {k: _row_repr(v) for k, v in row.items()}
    if isinstance(row, tuple):
        return tuple(_row_repr(v) for v in row)
    x = np.asarray(row)
    return x.item() if x.ndim == 0 else x.tolist()


def _row_json(row):
    r = _row_repr(row)
    if isinstance(r, tuple):
        return list(r)
    return r
