"""Kernel tier: capability checks, mode resolution, autotune memo.

The shuffle engine's wide stages (core/shuffle.py) each have a kernel (the
segment scan, the prefix scan, the bucket router) and a plain-torch path
that is always available. This module decides, per wide node, which runs:

* **Mode** (``ignis.kernels``): ``auto`` uses the compiled kernels on a
  CUDA worker and the plain path elsewhere; ``on`` forces the kernel tier
  (compiled on CUDA, the kernel's plain version on the CPU); ``interpret``
  forces the kernel tier with the plain version standing in for the kernel
  on the CPU (the counterpart of Pallas's interpret mode, so hit and
  fallback counters read as the reference's); ``off`` forces the plain
  path.
* **Capability probe**: a tiny invocation per (kernel, interpret, device),
  cached. The ``kernel.capability`` fault site fires on every selection so
  chaos tests can force mid-job degradation.
* **Autotune memo**: best block size per (kernel, aval, op) key, found by a
  timed sweep over ``ignis.kernels.blocks`` candidates (the threads per
  block of the segmented scan, of the prefix scan it carries, and of the
  bucket router); an LRU
  with one-sweep-per-key discipline. Tuned blocks feed the wide-plan cache
  key.

**No fallback that hides the kernel.** The reference swallows a failed
probe and a failed autotune sweep and runs its plain path. On a CUDA worker
the port does neither: a probe, build or launch failure raises. A failed
probe on the CPU still degrades, as the reference does; and the deliberate,
counted ``kernel.capability`` fault injection still degrades everywhere.

``compiled_backend`` is "the worker's device is CUDA". ``builtin_reduce_op``
recognises a reduce function by tracing it with ``make_fx``.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.kernels import sweeping

#: dtypes the kernel tier computes natively (bool rides as i32)
SUPPORTED_DTYPES = (torch.float32, torch.int32)


def compiled_backend(device="cpu") -> bool:
    """True where a wide stage's kernel is the compiled CUDA kernel."""
    return torch.device(device).type == "cuda"


@dataclass(frozen=True)
class Selection:
    """A resolved kernel choice: which kernel, plain stand-in or compiled."""

    kernel: str
    interpret: bool

    def describe(self) -> str:
        return f"{self.kernel}[{'interpret' if self.interpret else 'compiled'}]"


# ---------------------------------------------------------------------------
# capability probes: one tiny invocation per kernel
# ---------------------------------------------------------------------------


def _probe_segment_reduce(device):
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_reduce_fwd

    v = torch.zeros((8, 1), dtype=torch.float32, device=device)
    hb = torch.ones((8,), dtype=torch.bool, device=device)
    segment_reduce_fwd(v, hb, op="sum", block=8)


def _probe_prefix_scan(device):
    from repro_torch.kernels.ssd_scan.prefix import prefix_scan_fwd

    prefix_scan_fwd(torch.zeros((8,), dtype=torch.int32, device=device), op="min",
                    block=8)


def _probe_bucket_route(device):
    from repro_torch.kernels.moe_route.route import bucket_route_fwd

    d = torch.zeros((8,), dtype=torch.int32, device=device)
    bucket_route_fwd(d, p=2, capacity=4, block=8)


_PROBES: dict = {
    "segment_reduce": _probe_segment_reduce,
    "prefix_scan": _probe_prefix_scan,
    "bucket_route": _probe_bucket_route,
}


# ---------------------------------------------------------------------------
# builtin-op recognition: which reduce fns the kernel tier can take over
# ---------------------------------------------------------------------------

_ATEN_OPS = {"aten.add.Tensor": "sum", "aten.maximum.default": "max",
             "aten.minimum.default": "min"}


def builtin_reduce_op(fn, identity, value) -> Optional[str]:
    """Recognize a reduceByKey fn as a builtin sum/max/min the segment
    kernel implements, or None (→ plain-path fallback).

    Eligibility (anything else falls back, never errors): the value is a
    single tensor leaf of a supported dtype with ndim ≤ 2, the identity is
    a single scalar leaf, and ``fn`` traces (``make_fx`` on two scalars) to
    exactly one add/maximum/minimum applied to its two arguments with no
    dtype change.
    """
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.core import tree

    leaves = tree.leaves(value)
    ileaves = tree.leaves(identity)
    ident = ileaves[0] if len(ileaves) == 1 else None
    ndim = ident.ndim if isinstance(ident, torch.Tensor) else np.ndim(ident)
    if len(leaves) != 1 or len(ileaves) != 1 or ndim != 0:
        return None
    leaf = leaves[0]
    dtype = getattr(leaf, "dtype", None)
    if dtype not in SUPPORTED_DTYPES or leaf.ndim > 2:
        return None
    a, b = torch.zeros((), dtype=dtype), torch.zeros((), dtype=dtype)
    try:
        graph = make_fx(fn)(a, b).graph
        out = fn(a, b)
    except Exception:
        return None
    calls = [n for n in graph.nodes if n.op == "call_function"]
    inputs = [n for n in graph.nodes if n.op == "placeholder"]
    if len(calls) != 1 or len(inputs) != 2:
        return None
    op = _ATEN_OPS.get(str(calls[0].target))
    if op is None or len(calls[0].args) != 2 or calls[0].kwargs:
        return None
    # both operands must be the fn's own arguments (rejects a+const, a+a)
    if {id(x) for x in calls[0].args} != {id(x) for x in inputs}:
        return None
    if not isinstance(out, torch.Tensor) or out.dtype != dtype or out.shape != ():
        return None
    return op


class KernelRegistry:
    """Per-worker kernel capability + autotune state (one per
    ShuffleManager; thread-safe — gang tasks share it)."""

    MODES = ("auto", "on", "off", "interpret")

    def __init__(self, mode: str = "auto", blocks="128,256,512",
                 tune_cache_size: int = 512, device="cpu"):
        # deferred: importing repro_torch.core runs its __init__, which
        # imports shuffle_plan, which imports this module
        from repro_torch.core.metrics import Counters

        mode = str(mode).strip().lower()
        if mode not in self.MODES:
            raise ValueError(f"ignis.kernels={mode!r}: expected one of {self.MODES}")
        self.mode = mode
        self.device = torch.device(device)
        if isinstance(blocks, str):
            blocks = [int(b) for b in blocks.replace(",", " ").split()]
        self.blocks = tuple(int(b) for b in blocks) or (256,)
        self.tune_cache_size = int(tune_cache_size)
        self._lock = threading.Lock()
        self._probe_cache: dict = {}
        self._tunes: "OrderedDict[tuple, int]" = OrderedDict()
        self._tuning: dict = {}  # key → Event while a sweep is in flight
        self.stats = Counters("kernels", {
            "kernel_hits": 0,        # wide nodes that ran kernel-backed
            "kernel_fallbacks": 0,   # kernel-eligible nodes on the plain path
            "autotune_runs": 0,      # block-size sweeps performed
            "autotune_evictions": 0,
        })

    def _bump(self, key: str, n: int = 1):
        with self._lock:
            self.stats[key] += n

    # ------------------------------------------------------------------
    # selection
    # ------------------------------------------------------------------
    def _probe(self, kernel: str, interpret: bool) -> bool:
        key = (kernel, interpret, str(self.device))
        with self._lock:
            if key in self._probe_cache:
                return self._probe_cache[key]
        if compiled_backend(self.device):
            # on the card a probe failure is a build or launch failure:
            # it raises, it never degrades to the plain path
            with sweeping():
                _PROBES[kernel](self.device)
            ok = True
        else:
            try:
                _PROBES[kernel](self.device)
                ok = True
            except Exception:
                ok = False
        with self._lock:
            self._probe_cache[key] = ok
        return ok

    def select(self, kernel: str) -> Optional[Selection]:
        """Resolve one kernel-eligible wide node. None → plain-path
        fallback (always available, bit-identical for exact ops).

        A ``kernel.capability`` fault degrades to the fallback rather than
        erroring — capability loss mid-job must not kill the job (unlike
        ``kernel.stage``, which is a task fault the scheduler retries via
        lineage)."""
        from repro_torch.core import faults

        if self.mode == "off":
            return self._fallback()
        try:
            faults.check("kernel.capability", kernel=kernel)
        except faults.FaultInjected:
            return self._fallback()
        compiled = compiled_backend(self.device)
        if self.mode == "auto":
            if not compiled:
                # the plain stand-in is no faster than the plain path —
                # auto takes the kernel tier only where it is compiled
                return self._fallback()
            interpret = False
        elif self.mode == "interpret":
            interpret = True
        else:  # "on": compiled where the device supports it
            interpret = not compiled
        if not self._probe(kernel, interpret):
            return self._fallback()
        self._bump("kernel_hits")
        return Selection(kernel, interpret)

    def _fallback(self) -> None:
        self._bump("kernel_fallbacks")
        return None

    def demote(self):
        """Re-book the last counted hit as a fallback."""
        with self._lock:
            self.stats["kernel_hits"] -= 1
            self.stats["kernel_fallbacks"] += 1

    # ------------------------------------------------------------------
    # autotune memo (one sweep per key, LRU)
    # ------------------------------------------------------------------
    def tune(self, key: tuple, candidates, timer: Callable[[int], float]) -> int:
        """Best block size for ``key``; memoised. ``timer(block)`` returns
        seconds for one representative invocation at that block size.
        Concurrent misses on one key cost exactly one sweep; a failed sweep
        raises and unparks the waiters (one of them re-tunes)."""
        while True:
            with self._lock:
                b = self._tunes.get(key)
                if b is not None:
                    self._tunes.move_to_end(key)
                    return b
                building = self._tuning.get(key)
                if building is None:
                    building = self._tuning[key] = threading.Event()
                    break
            building.wait()
        try:
            cands = sorted({int(c) for c in candidates})
            if not cands:
                raise ValueError("autotune: empty candidate set")
            best, best_t = cands[0], float("inf")
            if len(cands) > 1:  # a single candidate needs no timing
                with sweeping():
                    for c in cands:
                        t = timer(c)
                        if t < best_t:
                            best, best_t = c, t
            with self._lock:
                self.stats["autotune_runs"] += 1
                self._tunes[key] = best
                while len(self._tunes) > self.tune_cache_size:
                    self._tunes.popitem(last=False)
                    self.stats["autotune_evictions"] += 1
            return best
        finally:
            with self._lock:
                self._tuning.pop(key, None)
            building.set()

    def describe(self) -> str:
        s = self.stats
        return (f"mode={self.mode} hits={s['kernel_hits']} "
                f"fallbacks={s['kernel_fallbacks']} "
                f"autotune_runs={s['autotune_runs']} "
                f"autotune_evictions={s['autotune_evictions']} "
                f"tuned_keys={len(self._tunes)}")
