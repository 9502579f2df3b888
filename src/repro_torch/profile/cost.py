"""The cost model: price work before running it, learn from having run it
(the port of ``repro.profile.cost``; docs/profiling.md §cost).

Two complementary halves share one object so scheduler decisions have a
single thing to consult:

* **static pricing** — walk an aten-level FX graph (``price_graph``;
  ``price_fn`` traces a function to one on fake tensors, with no device
  work: the counterpart of the reference's jaxpr on ``ShapeDtypeStruct``s)
  or compiled HLO text (``price_hlo``, through the port's copy of the
  ``launch/hlo_cost.py`` parser) into a ``CostEstimate`` (flops, HBM bytes,
  wire bytes, dispatches), then convert to predicted seconds through
  ``DeviceParams`` — the model *sums* the terms (the runtime interleaves
  phases) and lets calibration absorb overlap;
* **dynamic history** — observed durations of tasks keyed by structural
  signature (``node_sig``), the empirical side that speculative-timeout
  derivation reads, and the sightings of fused-stage signatures that the
  fusion policy (``should_fuse``) weighs.

Graph pricing follows the reference's jaxpr rules op for op: one dispatch
per op, HBM bytes as operand plus result bytes, ``2·batch·M·N·K`` for a
contraction, no flops for ops that only move or reshape data
(``_FREE_OPS``, the aten counterparts of the reference's free primitives),
one flop per output element for every other op. Two rules are the port's
own: an allocation (``empty``) launches nothing in torch and prices
nothing, and a call of one of the port's kernel wrappers prices as one
kernel call — one dispatch, its operands' and results' bytes, and the
operations of its work (``repro_torch.kernels.fake_call``) — where the
reference prices a ``pallas_call`` body once per call.

A loop of identical iterations may be traced once and priced as many
times (``repeated``; the counterpart of the HLO parser's trip-count
multiply of ``while`` bodies): the query-chunk loop of the plain attention
does so inside ``collapsing_loops()``, which the dry run turns on. Each node
traced in such a region carries its count in ``node.meta["repeat"]``, and
``price_graph`` and ``memory_walk`` read it, so the collapsed graph prices
exactly as the unrolled one.
"""
from __future__ import annotations

import contextlib
import operator
import statistics
import threading
from collections import deque
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class DeviceParams:
    """Sustained-rate device constants. Defaults are deliberately modest
    host-CPU figures (the reference's, so the fusion policy decides as the
    reference does); ``calibration.calibrate()`` replaces the rates with
    measured ones, and ``CostModel.fit`` rescales the whole prediction
    against traced reality."""

    flops_per_s: float = 5e10
    hbm_bytes_per_s: float = 1e10
    wire_bytes_per_s: float = 2e9
    dispatch_s: float = 50e-6       # per eager/jit call overhead
    compile_s_per_op: float = 8e-3  # the reference's XLA compile cost per fused operator


@dataclass(frozen=True)
class CostEstimate:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    wire_bytes: float = 0.0
    dispatches: float = 0.0

    def __add__(self, other: "CostEstimate") -> "CostEstimate":
        return CostEstimate(
            self.flops + other.flops,
            self.hbm_bytes + other.hbm_bytes,
            self.wire_bytes + other.wire_bytes,
            self.dispatches + other.dispatches,
        )

    def scaled(self, k: float) -> "CostEstimate":
        return CostEstimate(self.flops * k, self.hbm_bytes * k,
                            self.wire_bytes * k, self.dispatches * k)


#: aten ops that move or reshape data without arithmetic: the counterparts
#: of the reference's free primitives (broadcast_in_dim, reshape, squeeze,
#: transpose, convert_element_type, slice, dynamic_(update_)slice,
#: concatenate, pad, gather, scatter, copy, device_put, stop_gradient, iota)
_FREE_OPS = frozenset((
    "view", "_unsafe_view", "reshape", "expand", "squeeze", "unsqueeze",
    "permute", "transpose", "t", "alias", "as_strided", "detach",
    "lift_fresh_copy", "_to_copy", "slice", "select", "narrow", "split",
    "split_with_sizes", "unbind", "slice_scatter", "select_scatter", "cat",
    "stack", "constant_pad_nd", "pad", "gather", "scatter", "index",
    "index_select", "index_put", "take", "copy", "copy_", "clone", "repeat",
    "arange", "full", "full_like", "zeros", "zeros_like", "ones", "ones_like",
    "scalar_tensor",
))
#: allocations: torch launches no device work for them
_ALLOC_OPS = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                        "new_empty_strided"))
#: contractions (``matmul``, ``einsum`` and ``linear`` reach an aten graph as
#: these), priced 2·(output elements)·K
_DOT_OPS = frozenset(("mm", "addmm", "bmm", "baddbmm", "dot", "mv"))


def _tensors(v):
    """The tensors in a node's value (a tensor, or a tuple/list of them)."""
    import torch

    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, (tuple, list)):
        return [t for x in v for t in _tensors(x)]
    return []


def _nbytes(v) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(v))


def _nelems(v) -> int:
    return sum(t.numel() for t in _tensors(v))


def _operand_nodes(node):
    """The value-carrying nodes among a node's arguments, flattened."""
    import torch.fx as fx

    out = []

    def walk(a):
        if isinstance(a, fx.Node):
            if a.op != "get_attr":
                out.append(a)
        elif isinstance(a, (tuple, list)):
            for x in a:
                walk(x)
        elif isinstance(a, dict):
            for x in a.values():
                walk(x)

    walk(node.args)
    walk(node.kwargs)
    return out


def _contracted(node, name: str) -> int:
    """K of a contraction node: its first product operand's last extent
    (``addmm``/``baddbmm`` take the bias first)."""
    a = _operand_nodes(node)[1 if name in ("addmm", "baddbmm") else 0]
    return int(a.meta["val"].shape[-1])


def _op_name(target) -> str:
    packet = getattr(target, "overloadpacket", None)
    return packet.__name__ if packet is not None else getattr(target, "__name__", str(target))


def _price_nodes(nodes) -> CostEstimate:
    """The module docstring's rules over ``nodes`` of an aten graph."""
    import torch

    flops = hbm = dispatches = 0.0
    for node in nodes:
        target = node.target
        # a higher-order op (``torch.cond``, ``while_loop``) is one op, as
        # the reference's walker prices ``cond`` and ``while`` (their
        # bodies sit under params it does not enter); getitem and other
        # python-level glue are no op at all
        if node.op != "call_function" or not isinstance(
                target, (torch._ops.OpOverload, torch._ops.HigherOrderOperator)):
            continue
        name = _op_name(target)
        if name in _ALLOC_OPS:
            continue
        k = _repeat(node)
        out = node.meta.get("val")
        hbm += k * sum(_nbytes(a.meta.get("val")) for a in _operand_nodes(node))
        hbm += k * _nbytes(out)
        dispatches += k
        if name in _DOT_OPS:
            flops += k * 2.0 * _nelems(out) * _contracted(node, name)
        elif name not in _FREE_OPS:
            flops += k * _nelems(out)
    return CostEstimate(flops, hbm, 0.0, dispatches)


def _price_calls(gm) -> CostEstimate:
    """The kernel calls a trace met (``gm.meta["kernel_calls"]``)."""
    est = CostEstimate()
    for call in gm.meta.get("kernel_calls", ()):
        est = est + CostEstimate(call.flops, call.bytes, 0.0, 1.0).scaled(call.count)
    return est


class CostModel:
    """See module docstring. Thread-safe: gang tasks consult one model from
    several scheduler threads at once."""

    def __init__(self, params: DeviceParams | None = None,
                 history: int = 64):
        self.params = params or DeviceParams()
        self._scale = 1.0  # fit() multiplier applied to every prediction
        self._lock = threading.Lock()
        self._history = history
        self._task_durs: dict = {}      # key -> deque[float seconds]
        self._stage_sightings: dict = {}  # stage signature -> times planned
        self.stats = {
            "jaxprs_priced": 0,  # graphs priced (the reference's key)
            "hlo_priced": 0,
            "fuse_decisions": 0,
            "fuse_deferrals": 0,
            "auto_timeouts": 0,
            "tasks_observed": 0,
        }

    # ------------------------------------------------------------------
    # static pricing
    # ------------------------------------------------------------------
    def price_graph(self, gm, nblocks: int = 1) -> CostEstimate:
        """Price an aten-level ``torch.fx.GraphModule`` (``make_fx``'s) by
        the module docstring's rules, adding the kernel calls its trace met
        (``gm.meta["kernel_calls"]``, set by ``price_fn``). ``nblocks``
        scales the estimate across a node's block loop."""
        est = _price_nodes(gm.graph.nodes) + _price_calls(gm)
        with self._lock:
            self.stats["jaxprs_priced"] += 1
        return est.scaled(nblocks)

    def price_parts(self, gm, mark: str) -> tuple:
        """``price_graph``'s estimate cut at a ``mark``: (the nodes up to and
        including the marked one and every kernel call, the nodes after
        it). A step marked after its gradients splits so into its forward
        and backward, and its optimizer update (which calls no kernel)."""
        nodes = list(gm.graph.nodes)
        cut = next(i for i, n in enumerate(nodes) if n.meta.get("mark") == mark) + 1
        before = _price_nodes(nodes[:cut]) + _price_calls(gm)
        with self._lock:
            self.stats["jaxprs_priced"] += 1
        return before, _price_nodes(nodes[cut:])

    def price_hlo(self, hlo_text: str, collective: bool = True) -> CostEstimate:
        """Price compiled HLO text through the port's copy of the parser
        (launch/hlo_cost.py): exact flops/HBM/wire accounting including
        while-loop trip counts and fusion boundary buffers."""
        from repro_torch.launch.hlo_cost import analyze

        a = analyze(hlo_text)
        with self._lock:
            self.stats["hlo_priced"] += 1
        return CostEstimate(
            flops=a["flops_per_device"],
            hbm_bytes=a["hbm_bytes_per_device"],
            wire_bytes=a["wire_bytes_per_device"] if collective else 0.0,
            dispatches=1.0,
        )

    def price_fn(self, fn, *tensors, nblocks: int = 1) -> CostEstimate:
        """Price a python function by tracing it to an aten graph on fake
        copies of ``tensors`` (real, meta or fake tensors, or pytrees of
        them: shapes, dtypes and devices only — no device work, and a CUDA
        tensor stays a CUDA one). A call of one of the port's kernel
        wrappers prices as one kernel call, on either device."""
        return self.price_graph(trace(fn, *tensors), nblocks)

    def predict_s(self, est: CostEstimate) -> float:
        """Predicted wall seconds for an estimate — summed terms (see
        module docstring), scaled by the ``fit()`` calibration factor."""
        p = self.params
        return self._scale * (
            est.flops / p.flops_per_s
            + est.hbm_bytes / p.hbm_bytes_per_s
            + est.wire_bytes / p.wire_bytes_per_s
            + est.dispatches * p.dispatch_s
        )

    def fit(self, pairs: list[tuple[float, float]]) -> float:
        """Calibrate against (predicted_s, observed_s) pairs: the scale
        becomes the median observed/predicted ratio (robust to a stray
        straggler pair). Returns the new scale."""
        ratios = [obs / pred for pred, obs in pairs if pred > 0 and obs > 0]
        if ratios:
            self._scale *= statistics.median(ratios)
        return self._scale

    def with_params(self, **kw) -> "CostModel":
        m = CostModel(replace(self.params, **kw), history=self._history)
        m._scale = self._scale
        return m

    # ------------------------------------------------------------------
    # decision 1: cost-aware fusion boundaries (DagEngine.plan)
    # ------------------------------------------------------------------
    def should_fuse(self, signature, n_ops: int, nblocks: int = 1) -> bool:
        """Is building this narrow chain into one fused stage worth it?

        On the FIRST sighting of a signature the build is unamortised — fuse
        only if this single run already saves more dispatch overhead
        (``(n_ops - 1) x nblocks`` calls) than the build costs
        (``compile_s_per_op x n_ops``). From the second sighting on, the
        plan cache amortises it: always fuse."""
        p = self.params
        with self._lock:
            seen = self._stage_sightings.get(signature, 0)
            self._stage_sightings[signature] = seen + 1
            self.stats["fuse_decisions"] += 1
            if seen > 0:
                return True
            saved = (max(0, n_ops - 1)) * max(1, nblocks) * p.dispatch_s
            if saved >= n_ops * p.compile_s_per_op:
                return True
            self.stats["fuse_deferrals"] += 1
            return False

    def peek_fuse(self, signature) -> bool:
        """``should_fuse`` without recording a sighting — for ``explain()``."""
        with self._lock:
            return self._stage_sightings.get(signature, 0) > 0

    # ------------------------------------------------------------------
    # decision 2: cost-derived speculative timeouts (IJob._evaluator)
    # ------------------------------------------------------------------
    def observe_task(self, key, dur_s: float):
        """Record one observed task duration under a structural key —
        typically ``(kind, node_sig(node))``."""
        if dur_s < 0:
            return
        with self._lock:
            q = self._task_durs.get(key)
            if q is None:
                q = self._task_durs[key] = deque(maxlen=self._history)
            q.append(dur_s)
            self.stats["tasks_observed"] += 1

    def typical_s(self, key) -> float | None:
        """Median observed duration for ``key`` (None with no history)."""
        with self._lock:
            q = self._task_durs.get(key)
            if not q:
                return None
            return statistics.median(q)

    def speculative_timeout_s(self, key, factor: float = 3.0,
                              default_s: float = 30.0) -> float:
        """The straggler deadline for a task: ``factor x`` its typical
        observed duration, floored at 50 ms, falling back to ``default_s``
        before any history exists."""
        typical = self.typical_s(key)
        with self._lock:
            self.stats["auto_timeouts"] += 1
        if typical is None:
            return default_s
        return max(0.05, factor * typical)

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {**self.stats,
                    "scale": self._scale,
                    "task_keys": len(self._task_durs),
                    "stage_signatures": len(self._stage_sightings)}


def trace(fn, *tensors):
    """``fn`` traced to an aten-level ``GraphModule`` on fake copies of
    ``tensors`` (``make_fx``, fake mode: no data is read and nothing runs
    on a device). The port's kernel calls met in the trace are recorded, as
    ``KernelCall``s, in ``gm.meta["kernel_calls"]``."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.kernels import recording_calls

    with recording_calls() as calls:
        gm = make_fx(fn, tracing_mode="fake")(*tensors)
    gm.meta["kernel_calls"] = tuple(calls)
    return gm


# ---------------------------------------------------------------------------
# loops traced once, marks, and the live-memory walk
# ---------------------------------------------------------------------------

_loops = threading.local()


def _repeat(node) -> int:
    return node.meta.get("repeat", (1, None))[0]


def _graph_in_trace():
    """The graph ``make_fx`` is building on this thread, or None."""
    from torch.fx.experimental.proxy_tensor import get_proxy_mode

    mode = get_proxy_mode()
    return None if mode is None else mode.tracer.graph


@contextlib.contextmanager
def collapsing_loops():
    """Inside the block, a loop that asks (``collapses()``) traces one of its
    identical iterations under ``repeated``."""
    prev = getattr(_loops, "on", False)
    _loops.on = True
    try:
        yield
    finally:
        _loops.on = prev


def collapses() -> bool:
    """Whether a loop traced now may trace one iteration for all of them:
    inside ``collapsing_loops()`` and a ``make_fx`` trace."""
    return getattr(_loops, "on", False) and _graph_in_trace() is not None


@contextlib.contextmanager
def repeated(count: int):
    """The ops traced inside the block stand for ``count`` copies of
    themselves (one iteration of a loop of ``count`` identical ones): each
    node traced here gets ``meta["repeat"] = (count, region)``, and each
    kernel call recorded here ``count`` calls. Nested regions multiply."""
    from repro_torch.kernels import _priced

    graph = _graph_in_trace()
    if graph is None:
        raise RuntimeError("repeated() outside a make_fx trace")
    start = len(graph.nodes)
    calls = getattr(_priced, "calls", None)
    n_calls = len(calls) if calls is not None else 0
    yield
    region = object()
    for node in list(graph.nodes)[start:]:
        k, _ = node.meta.get("repeat", (1, None))
        node.meta["repeat"] = (k * count, region)
    if calls is not None:
        for i in range(n_calls, len(calls)):
            calls[i] = calls[i]._replace(count=calls[i].count * count)


def mark(name: str) -> None:
    """Name the point a trace has reached (the last node traced so far
    gets ``meta["mark"] = name``); ``memory_walk`` reports the live bytes
    there. Outside a trace, nothing."""
    graph = _graph_in_trace()
    if graph is not None and len(graph.nodes):
        list(graph.nodes)[-1].meta["mark"] = name


def _aliases(node) -> bool:
    """Whether a node's result shares its first operand's storage (a view,
    an in-place op, ``getitem`` of a multi-result op)."""
    import torch

    if node.target is operator.getitem:
        return True
    schema = getattr(node.target, "_schema", None)
    if not isinstance(node.target, torch._ops.OpOverload) or schema is None:
        return False
    return any(r.alias_info is not None for r in schema.returns)


def memory_walk(gm) -> dict:
    """The bytes of live intermediates as the graph runs in order: each
    allocating node's result lives from its node to the last use of it or
    of a view of it; views and in-place results allocate nothing; inputs,
    constants (weights) and the graph's outputs are not intermediates. A
    result made inside a ``repeated`` region that outlives the region
    counts once per copy. Returns ``{"peak": bytes, "marks": {name: live
    bytes after the marked node}}``."""
    nodes = list(gm.graph.nodes)
    index = {n: i for i, n in enumerate(nodes)}
    owner, size = {}, {}
    for n in nodes:
        if n.op != "call_function":
            owner[n] = None
            continue
        ops = _operand_nodes(n)
        if _aliases(n) and ops:
            owner[n] = owner.get(ops[0])
        else:
            owner[n] = n
            size[n] = _nbytes(n.meta.get("val"))
    last = {}
    for n in nodes:
        for a in _operand_nodes(n):
            o = owner.get(a)
            if o is not None:
                last[o] = max(last.get(o, 0), index[n])
    outputs = {owner.get(a) for n in nodes if n.op == "output" for a in _operand_nodes(n)}
    region_end = {}
    for n in nodes:
        k, region = n.meta.get("repeat", (1, None))
        if region is not None:
            region_end[region] = index[n]
    frees = {}
    for o, i in last.items():
        frees.setdefault(i, []).append(o)
    live = peak = 0
    held, marks = {}, {}
    for i, n in enumerate(nodes):
        if owner.get(n) is n and n not in outputs:
            k, region = n.meta.get("repeat", (1, None))
            b = size[n] * (k if region is not None and last.get(n, i) > region_end[region] else 1)
            held[n] = b
            live += b
            peak = max(peak, live)
        for o in frees.get(i, ()):
            live -= held.pop(o, 0)
        if n not in last and n in held:  # never used
            live -= held.pop(n)
        if "mark" in n.meta:
            marks[n.meta["mark"]] = live
    return {"peak": peak, "marks": marks}
