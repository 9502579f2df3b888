"""Lazy task-dependency graph with lineage fault tolerance (paper §3.5, Fig 3)
and stage compilation (DESIGN.md §5).

Driver calls register TaskNodes; nothing executes until an *action*. A node's
result is kept only for the duration of one action evaluation unless the user
``cache()``d it. Narrow nodes (map/filter/…) have block-wise lineage: block i
depends only on the parents' block i, so a lost cached block is recomputed
alone; wide nodes (shuffles) recompute whole-node. Executor/container tasks
(paper Fig. 3) correspond to the mesh existing — checked at evaluation.

Stage compilation: before an action runs, a planner pass collapses maximal
chains of fusable narrow nodes into ``FusedStage``s — one composed block
function, built once per (op-chain signature, block avals) and reused across
blocks and across actions via the engine's plan cache. This is the paper's
§3.5 task pipelining (one executor task per stage, not per operator): a
map.filter.map chain is one composed call per block whose interior blocks
are never recorded as node results. The composed chain runs eagerly (torch
needs no trace to run on the card); the plan cache keeps the counters and
``explain()`` identical to the reference's jitted stages. Fusion is an
*overlay*: the constituent TaskNodes keep their
``block_fn``s, so lineage repair of a cached stage output still re-derives
individual blocks by walking the original narrow chain.
"""
from __future__ import annotations

import itertools
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core import comm, faults
from repro_torch.core.metrics import Counters

_ids = itertools.count()


@dataclass
class TaskNode:
    op: str
    parents: list
    # fn(list_of_parent_block_lists) -> list[Block]      (wide)
    # block_fn(parent_blocks_at_i: list[Block]) -> Block (narrow)
    fn: Optional[Callable] = None
    block_fn: Optional[Callable] = None
    narrow: bool = False
    cached: bool = False
    # fusion metadata: a composable Block -> Block kernel
    # equivalent to block_fn for single-parent narrow ops, plus a hashable
    # signature component. None ⇒ the op is opaque to the planner (wide ops,
    # spark-mode pipe-wrapped ops, non-traceable partition fns).
    fuse_fn: Optional[Callable] = None
    fuse_key: Optional[tuple] = None
    # structural lineage signature (set by the dataframe layer): identifies
    # "the same computation" across actions and across re-built lineages —
    # the key of the shuffle engine's capacity memory (DESIGN.md §6). For
    # shuffle-backed wide ops, shuffle_sig is set (= sig) so explain() can
    # annotate the node with its capacity state.
    sig: Optional[tuple] = None
    shuffle_sig: Optional[tuple] = None
    # job-scheduler routing (core/job.py): the IWorker whose engine owns this
    # node, and the task class it maps to in a job DAG ("dataflow" | "native").
    # Owner is stamped by the driver layer (IDataFrame / worker.call) — an
    # edge whose endpoints have different owners is a cross-worker task
    # boundary; native nodes are always their own job task.
    owner: Optional[object] = None
    task_kind: str = "dataflow"
    # checkpoint-aware lineage (docs/fault_tolerance.md): a per-block loader
    # installed by IDataFrame.checkpoint(). When set, repair of a lost block
    # reads it back from stable storage instead of walking parents — the
    # node IS the truncation point of its lineage.
    restore_fn: Optional[Callable] = None
    id: int = field(default_factory=lambda: next(_ids))
    # runtime state
    result: Optional[list] = None  # list[Block] when materialised
    compute_count: int = 0  # telemetry for lineage tests

    def __hash__(self):
        return self.id

    def __eq__(self, other):
        return self is other


def node_sig(node: "TaskNode") -> tuple:
    """The node's structural signature, falling back to an id-unique tuple
    (still stable across repeated actions on the same node)."""
    return node.sig if node.sig is not None else ("id", node.id)


def _follow(block, parents):
    """A narrow stage's block stays committed where its input was (the
    reference's block functions keep their inputs' placement): a fresh
    output block takes the first committed parent block's ranks."""
    if block is not None and block.ranks is None:
        for pb in parents:
            if pb is not None and pb.ranks is not None:
                block.ranks = pb.ranks
                break
    return block


def _commit(node, blocks):
    """A wide or native stage's blocks are committed to the communicator it
    ran under: the owning worker's active context on this thread."""
    ctx = getattr(node.owner, "context", None)
    if ctx is not None:
        for b in blocks:
            if b is not None and b.ranks is None:
                b.ranks = tuple(ctx.ranks)
    return blocks


class FusedStage:
    """A maximal chain of fusable narrow nodes, head → tail.

    Interior nodes are never materialised; the stage's composed kernel maps a
    parent block straight to the tail's block. The tail keeps normal TaskNode
    semantics (memoisation, cache(), lineage repair)."""

    __slots__ = ("nodes", "signature")

    def __init__(self, nodes: list[TaskNode]):
        self.nodes = nodes  # head..tail order
        self.signature = tuple(n.fuse_key for n in nodes)

    @property
    def head(self) -> TaskNode:
        return self.nodes[0]

    @property
    def tail(self) -> TaskNode:
        return self.nodes[-1]

    def describe(self) -> str:
        return " -> ".join(n.op for n in self.nodes)


def _block_aval(block) -> tuple:
    from repro_torch.core.partition import block_aval

    return block_aval(block)


class DagEngine:
    """Evaluates actions over the task graph with memoisation + lineage.

    ``fusion=True`` enables the stage-compilation planner; the compiled-plan
    cache holds up to ``plan_cache_size`` composed stage kernels (LRU)."""

    def __init__(self, fusion: bool = True, plan_cache_size: int = 128,
                 fusion_mode: str = "static", cost_model=None):
        self.fusion = fusion
        # fusion boundary policy (docs/profiling.md §fusion): "static"
        # fuses every eligible chain; "cost" asks the cost model whether
        # the stage build will pay for itself
        self.fusion_mode = fusion_mode
        self.cost_model = cost_model  # repro_torch.profile.cost.CostModel | None
        # live span hook (docs/profiling.md): JobTracer.attach_worker sets
        # this to its buffer's record(name, cat, t0, t1, **args)
        self.trace_hook = None
        self.plan_cache_size = plan_cache_size
        self._plan_cache: "OrderedDict[tuple, Callable]" = OrderedDict()
        # gang-scheduled tasks (core/job.py) enter one engine from several
        # threads at once (disjoint sub-meshes of one worker); the LRU's
        # get+move/insert+evict sequences are not atomic under the GIL
        import threading

        self._plan_lock = threading.Lock()
        # the "stages/" namespace of the worker's metrics tree
        # (core/metrics.py; worker.stage_stats() is the legacy facade)
        self.stats = Counters("stages", {
            "node_computes": 0,
            "wide_computes": 0,
            "block_recomputes": 0,
            "fused_stages": 0,
            "fused_ops": 0,
            "plan_cache_hits": 0,
            "plan_cache_misses": 0,
            "plan_cache_evictions": 0,
            "iter_block_computes": 0,
            "block_restores": 0,  # blocks repaired from a checkpoint
            "speculative_retries": 0,  # straggler duplicates launched
            "handle_awaits": 0,  # CollHandle-valued node results awaited
            "fusion_deferred": 0,  # chains the cost policy left unfused
        })

    # ---- planner (stage compilation) ----------------------------------------
    @staticmethod
    def _fusable(node: TaskNode) -> bool:
        return (
            node.narrow
            and node.fuse_fn is not None
            and len(node.parents) == 1
            and node.result is None
        )

    def _walk(self, root: TaskNode):
        """Iterative post-order DFS → (order: parents-before-consumers,
        refs: consumer counts within the reachable graph). Mirrors _eval's
        short-circuit: the subgraph below a hole-free materialised node will
        never recompute, so it is not descended into — planning stays O(live
        graph) on iterative workloads with ever-growing lineage."""

        def expand(n: TaskNode):
            if n.result is not None and not self._has_holes(n):
                return iter(())
            return iter(n.parents)

        refs: dict[TaskNode, int] = {}
        order: list[TaskNode] = []
        seen = {root}
        stack: list[tuple[TaskNode, iter]] = [(root, expand(root))]
        while stack:
            node, it = stack[-1]
            child = next(it, None)
            if child is None:
                order.append(node)
                stack.pop()
                continue
            refs[child] = refs.get(child, 0) + 1
            if child not in seen:
                seen.add(child)
                stack.append((child, expand(child)))
        return order, refs

    def plan(self, root: TaskNode,
             observe: bool = True) -> dict[TaskNode, FusedStage]:
        """Plan the action: map each fused-stage *tail* to its FusedStage.

        A chain grows from a tail down through parents that are fusable, not
        cached, unmaterialised and single-consumer — every condition marks a
        node whose blocks someone else needs, i.e. a stage boundary.

        Under ``fusion_mode="cost"`` each maximal chain additionally passes
        through ``CostModel.should_fuse`` (docs/profiling.md §fusion): a
        first-sighting signature whose dispatch savings cannot amortise the
        stage build is left UNFUSED this evaluation (counted in
        ``fusion_deferred``) and fuses from its second sighting, once the
        plan-cache reuse the compile needs is evidenced. ``observe=False``
        (``explain()``) makes the decision read-only so rendering a plan
        never perturbs it."""
        if not self.fusion:
            return {}
        pricing = self.fusion_mode == "cost" and self.cost_model is not None
        order, refs = self._walk(root)
        plans: dict[TaskNode, FusedStage] = {}
        absorbed: set[TaskNode] = set()
        for node in reversed(order):  # consumers first ⇒ maximal chains
            if node in absorbed or not self._fusable(node):
                continue
            chain = [node]
            p = node.parents[0]
            while (
                self._fusable(p)
                and not p.cached
                and refs.get(p, 0) == 1
                and p not in absorbed
            ):
                chain.append(p)
                p = p.parents[0]
            if len(chain) >= 2:
                chain.reverse()
                stage = FusedStage(chain)
                if pricing:
                    # block-count hint: a materialised stage input tells us
                    # how many dispatches one run saves; unknown → 1
                    src = stage.head.parents[0]
                    nblocks = (len(src.result)
                               if getattr(src, "result", None) else 1)
                    if observe:
                        fuse = self.cost_model.should_fuse(
                            stage.signature, len(chain), nblocks)
                    else:
                        fuse = self.cost_model.peek_fuse(stage.signature)
                    if not fuse:
                        self.stats["fusion_deferred"] += 1
                        absorbed.update(chain)  # evaluate unfused this time
                        continue
                plans[node] = stage
                absorbed.update(chain)
        return plans

    def explain(self, root: TaskNode, annotate=None) -> str:
        """Render the physical plan — which operators fuse into which stages.

        ``annotate(node) -> str`` lets another subsystem append per-node
        state (the shuffle engine adds capacity-memory annotations)."""
        plans = self.plan(root, observe=False)
        lines = ["== physical plan =="]
        emitted: set[int] = set()

        def tags(n: TaskNode) -> str:
            t = []
            if not n.narrow:
                t.append("wide")
            if n.task_kind == "native":
                t.append("native")
            if n.cached:
                t.append("cached")
            if n.result is not None:
                t.append("materialised")
            return f" [{', '.join(t)}]" if t else ""

        # iterative DFS — lineage graphs routinely exceed recursion depth
        stack: list[tuple[TaskNode, int]] = [(root, 0)]
        while stack:
            node, depth = stack.pop()
            if node.id in emitted:
                lines.append("  " * depth + f"({node.op}#{node.id} — shared, see above)")
                continue
            emitted.add(node.id)
            stage = plans.get(node)
            if stage is not None:
                lines.append(
                    "  " * depth
                    + f"FusedStage[{stage.describe()}]  ({len(stage.nodes)} ops, "
                    f"1 jit dispatch/block){' [cached]' if node.cached else ''}"
                )
                parents = stage.head.parents
            else:
                extra = annotate(node) if annotate is not None else ""
                lines.append("  " * depth + f"{node.op}#{node.id}{tags(node)}{extra}")
                parents = node.parents
            stack.extend((p, depth + 1) for p in reversed(parents))
        return "\n".join(lines)

    # ---- compiled-plan cache -------------------------------------------------
    def _compiled(self, stage: FusedStage, block) -> Callable:
        """Composed kernel for this stage specialised to the block's avals —
        fetched from (or inserted into) the LRU plan cache."""
        key = (stage.signature, _block_aval(block))
        with self._plan_lock:
            fn = self._plan_cache.get(key)
            if fn is not None:
                self._plan_cache.move_to_end(key)
                self.stats["plan_cache_hits"] += 1
                return fn
            self.stats["plan_cache_misses"] += 1
        kernels = [n.fuse_fn for n in stage.nodes]

        def composed(data, valid):
            from repro_torch.core.partition import Block

            b = Block(data, valid)
            for k in kernels:
                b = k(b)
            return b.data, b.valid

        fn = composed
        with self._plan_lock:
            self._plan_cache[key] = fn
            while len(self._plan_cache) > self.plan_cache_size:
                self._plan_cache.popitem(last=False)
                self.stats["plan_cache_evictions"] += 1
        return fn

    # ---- evaluation ---------------------------------------------------------
    def evaluate(self, node: TaskNode, memo: dict | None = None):
        memo = {} if memo is None else memo
        return self._eval(node, memo, self.plan(node))

    def evaluate_blocks_iter(self, node: TaskNode, memo: dict | None = None,
                             plans: dict | None = None):
        """Yield the node's blocks one at a time, pulling narrow chains
        lazily — early-exit actions (``take``) stop computing the moment
        they have enough rows instead of materialising every block. Fused
        stages stay fused: a stage tail yields one compiled dispatch per
        parent block through the same plan cache as full evaluation.

        Cached nodes and wide/opaque nodes fall back to full evaluation
        (their granularity is not incremental, and partial results must
        never be written into a ``cache()`` slot)."""
        from repro_torch.core.partition import Block

        memo = {} if memo is None else memo
        plans = self.plan(node) if plans is None else plans
        if node.result is not None and not self._has_holes(node):
            yield from node.result
            return
        if node in memo:
            yield from memo[node]
            return
        stage = plans.get(node)
        if stage is not None and not node.cached:
            out = []
            for pb in self.evaluate_blocks_iter(stage.head.parents[0], memo, plans):
                faults.check("dag.block", op=stage.tail.op, block=len(out), fused=True)
                self.stats["iter_block_computes"] += 1
                data, valid = self._compiled(stage, pb)(pb.data, pb.valid)
                b = Block(data, valid, pb.ranks)
                out.append(b)
                yield b
            for n in stage.nodes:  # telemetry parity with _compute_stage
                n.compute_count += 1
            self.stats["fused_stages"] += 1
            self.stats["fused_ops"] += len(stage.nodes)
            memo[node] = out
            return
        if (
            node.narrow
            and node.block_fn is not None
            and node.parents
            and not node.cached
        ):
            iters = [self.evaluate_blocks_iter(p, memo, plans) for p in node.parents]
            out = []
            for parents_i in zip(*iters):
                faults.check("dag.block", op=node.op, block=len(out), fused=False)
                self.stats["iter_block_computes"] += 1
                b = _follow(node.block_fn(list(parents_i)), parents_i)
                out.append(b)
                yield b
            # fully consumed ⇒ the node is materialised: record it in the
            # (possibly job-shared) memo so later tasks reuse instead of
            # recomputing; an abandoned (early-exit) iterator writes nothing
            node.compute_count += 1
            memo[node] = out
            return
        yield from self._eval(node, memo, plans)

    def _eval(self, node: TaskNode, memo: dict, plans: dict | None = None):
        plans = {} if plans is None else plans
        if node.result is not None and not self._has_holes(node):
            return node.result
        if node in memo:
            return memo[node]
        if node.result is not None and self._has_holes(node):
            blocks = self._repair(node, memo, plans)
        else:
            stage = plans.get(node)
            if stage is not None:
                blocks = self._compute_stage(stage, memo, plans)
            else:
                parent_results = [self._eval(p, memo, plans) for p in node.parents]
                blocks = self._compute(node, parent_results)
        memo[node] = blocks
        if node.cached:
            node.result = blocks
        return blocks

    def _compute(self, node: TaskNode, parent_results):
        node.compute_count += 1
        self.stats["node_computes"] += 1
        if node.narrow and node.block_fn is not None:
            nblocks = len(parent_results[0]) if parent_results else 0
            out = []
            for i in range(nblocks):
                faults.check("dag.block", op=node.op, block=i, fused=False)
                parents_i = [pr[i] for pr in parent_results]
                out.append(_follow(node.block_fn(parents_i), parents_i))
            return out
        faults.check("dag.node", op=node.op)
        self.stats["wide_computes"] += 1
        hook = self.trace_hook
        t0 = time.perf_counter() if hook is not None else 0.0
        out = node.fn(parent_results)
        if hook is not None:
            hook(f"wide:{node.op}", "engine", t0, time.perf_counter(),
                 op=node.op, node=node.id)
        if comm.is_handle(out):
            # a wide/native node may return a nonblocking collective handle
            # (e.g. an SPMD app handing back an in-flight result); the
            # engine is the synchronisation point for lineage, so it awaits
            # here — a FaultInjected from the pending handle surfaces like
            # any node failure and retries through the scheduler
            out = out.wait()
            self.stats["handle_awaits"] += 1
        return _commit(node, out)

    def _compute_stage(self, stage: FusedStage, memo: dict, plans: dict):
        """Run a fused stage: one compiled kernel per block, head's parent to
        tail, no interior materialisation."""
        from repro_torch.core.partition import Block

        parent_blocks = self._eval(stage.head.parents[0], memo, plans)
        hook = self.trace_hook
        t0 = time.perf_counter() if hook is not None else 0.0
        out = []
        for i, b in enumerate(parent_blocks):
            faults.check("dag.block", op=stage.tail.op, block=i, fused=True)
            fn = self._compiled(stage, b)
            data, valid = fn(b.data, b.valid)
            out.append(Block(data, valid, b.ranks))
        if hook is not None:
            hook(f"stage:{stage.tail.op}", "engine", t0, time.perf_counter(),
                 ops=len(stage.nodes), blocks=len(out),
                 stage=stage.describe())
        for n in stage.nodes:  # telemetry parity with the unfused path
            n.compute_count += 1
        self.stats["node_computes"] += len(stage.nodes)
        self.stats["fused_stages"] += 1
        self.stats["fused_ops"] += len(stage.nodes)
        return out

    # ---- lineage repair ------------------------------------------------------
    @staticmethod
    def _has_holes(node: TaskNode) -> bool:
        return node.result is not None and any(b is None for b in node.result)

    def _repair(self, node: TaskNode, memo: dict, plans: dict | None = None):
        """Recompute only the missing blocks of a cached node (narrow lineage);
        wide nodes fall back to full recompute. A fused-stage tail repairs by
        walking its constituent ops' block_fns — fusion never loses lineage.
        A checkpointed node (``restore_fn``) repairs from stable storage:
        lineage is truncated there, ancestors are never re-read."""
        plans = {} if plans is None else plans
        if node.restore_fn is not None:
            blocks = list(node.result)
            for i, b in enumerate(blocks):
                if b is None:
                    faults.check("dag.repair", op=node.op, block=i)
                    blocks[i] = node.restore_fn(i)
                    self.stats["block_restores"] += 1
            node.result = blocks
            return blocks
        if not node.narrow or node.block_fn is None:
            node.result = None
            parent_results = [self._eval(p, memo, plans) for p in node.parents]
            return self._compute(node, parent_results)
        blocks = list(node.result)
        for i, b in enumerate(blocks):
            if b is None:
                faults.check("dag.repair", op=node.op, block=i)
                parents_i = [self._parent_block(p, i, memo, plans) for p in node.parents]
                blocks[i] = _follow(node.block_fn(parents_i), parents_i)
                self.stats["block_recomputes"] += 1
        node.result = blocks
        return blocks

    def _parent_block(self, parent: TaskNode, i: int, memo: dict, plans: dict | None = None):
        if parent.result is not None and parent.result[i] is not None:
            return parent.result[i]
        if parent.restore_fn is not None:
            blk = parent.restore_fn(i)
            self.stats["block_restores"] += 1
            if parent.result is not None:
                parent.result[i] = blk
            return blk
        if parent.narrow and parent.block_fn is not None and parent.parents:
            gps = [self._parent_block(gp, i, memo, plans) for gp in parent.parents]
            blk = _follow(parent.block_fn(gps), gps)
            self.stats["block_recomputes"] += 1
            if parent.cached and parent.result is not None:
                parent.result[i] = blk
            return blk
        return self._eval(parent, memo, plans)[i]

    # ---- failure injection (tests / chaos) -----------------------------------
    @staticmethod
    def kill_block(node: TaskNode, i: int):
        """Simulate losing the executor holding block i of a cached node."""
        if node.result is not None:
            node.result = [None if j == i else b for j, b in enumerate(node.result)]

    @staticmethod
    def kill_executor(nodes, i: int):
        for n in nodes:
            DagEngine.kill_block(n, i)

    # ---- straggler mitigation -------------------------------------------------
    def evaluate_speculative(self, node: TaskNode, timeout_s: float = 30.0,
                             memo: dict | None = None, bind=None):
        """Speculative re-execution of slow tasks (paper §3.5 recovery path,
        generalised to stragglers): evaluate with a deadline; a task that
        exceeds it is re-launched (deterministic winner: first completion).
        The job scheduler applies this as the straggler policy for gang
        tasks when ``ignis.task.speculative`` is set (core/job.py).

        Each attempt evaluates through a private overlay of ``memo`` so the
        duplicate never races the straggler's half-written entries; the
        winner's materialisations are committed back to the shared memo.
        ``bind`` (a context-manager factory) is entered by EVERY attempt
        thread — thread-locals like the worker's active communicator do not
        cross thread spawns, so a gang task must re-bind its group here or
        its wide stages would silently retarget to the world mesh.

        On a single-process runtime the duplicate runs serially; on a real
        multi-host deployment the retry lands on a different executor set.
        """
        import contextlib
        import threading

        base = {} if memo is None else memo
        lock = threading.Lock()
        result: dict = {}
        done = threading.Event()

        def run():
            local = _OverlayMemo(base)
            try:
                with bind() if bind is not None else contextlib.nullcontext():
                    blocks = self._eval(node, local, self.plan(node))
            except Exception as e:  # surfaced to caller (first resolution wins)
                with lock:
                    if not done.is_set():
                        result["error"] = e
                        done.set()
                return
            with lock:
                if not done.is_set():
                    result["blocks"] = blocks
                    for k, v in local.items():  # commit the winner's work
                        base[k] = v
                    done.set()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        if not done.wait(timeout_s):
            # straggler: launch the speculative duplicate and take the winner
            self.stats["speculative_retries"] += 1
            t2 = threading.Thread(target=run, daemon=True)
            t2.start()
            done.wait()
        if "error" in result:
            raise result["error"]
        return result["blocks"]


class _OverlayMemo(dict):
    """Read-through/write-local view of an evaluation memo: speculative
    attempts see everything already materialised in the shared memo but
    keep their own writes private until the winner commits them."""

    __slots__ = ("_base",)

    def __init__(self, base: dict):
        super().__init__()
        self._base = base

    def __contains__(self, key):
        return dict.__contains__(self, key) or key in self._base

    def __getitem__(self, key):
        try:
            return dict.__getitem__(self, key)
        except KeyError:
            return self._base[key]

    def get(self, key, default=None):
        if dict.__contains__(self, key):
            return dict.__getitem__(self, key)
        return self._base.get(key, default)
