"""Hand-written Hopper kernels: the shuffle engine's wide stages and the
model zoo's attention, SSD scan and MoE router.

Each package holds the wrapper of its kernels (CUDA C++ under
``src/repro_torch/csrc``, built by ``_cuda.py`` at the first CUDA launch),
their plain torch versions (``ref.py``) and the public functions
(``ops.py``) that mask and pick between them by the device of the tensor
they are given:

  ssd_scan        — ``prefix_scan``: inclusive 1-D sum/min/max scan, forward
                    or from the tail (the suffix-min of ``segment_totals``'
                    last-row gather; one pass with a decoupled look-back, in
                    ``csrc/segment_reduce.cu``); ``ssd_scan``: the Mamba-2
                    SSD chunk scan, the SSM mixer's prefill
  segment_reduce  — ``segment_reduce`` / ``segment_totals``: inclusive
                    segmented scan (one pass with a decoupled look-back), the
                    reduceByKey post hook
  moe_route       — ``bucket_route``: capacity ordinals for the hash
                    exchange of partitionBy / join; ``moe_route``: softmax,
                    top-k and expert capacity ordinals; both one pass with a
                    decoupled look-back, the second the MoE FFN's router
  flash_attention — ``flash_attention``: online-softmax attention forward,
                    the transformers' prefill attention, and on its
                    ``wgmma`` route its backward (``flash_attention_bwd``,
                    which replaces no TPU kernel), the training backward
  decode_attention — ``decode_attention``: one query token a slot against
                    its live rows of the bf16 KV slab (split over the rows
                    where the slots are few), the transformers' decode
                    attention; it replaces no TPU kernel
  moe_experts     — ``grouped_experts``: the dropless MoE's expert SwiGLU
                    as PyTorch's grouped GEMM over the experts' segments;
                    not a kernel of the port, here to be counted with them

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel or raises — never the plain version. Each kernel's
dispatching function carries two plain integer counters: ``launches`` (one
per call that launched the kernel) and ``tune_launches`` (the same, during
an autotune sweep, so sweeps are counted apart from the path's own runs);
a kernel with more than one route also counts its launches per route in
``launches_by_variant`` (flash attention: ``wgmma`` or ``fma``, its
backward ``wgmma`` only; decode
attention: ``whole`` or ``split``), so a run
can show which route its path went through. A CUDA graph's capture runs
nothing: inside ``uncounted()`` the capturing thread's launches are taken
aside instead of counted, and ``credit_launches`` counts them at each
replay, so a replayed launch counts as an eager one.

A fake tensor (a tracer's: shapes without data, on either device) runs
nothing: the wrapper returns fresh tensors of its results' shapes through
``fake_call``, which the cost model's tracer (``profile.cost.trace``)
records as one kernel call. So a traced program prices a kernel call the
same on both devices, and a plain version whose shapes depend on the data
(the bucket router's ``bincount``) is never traced.

``registry.py`` is the capability/selection/autotune layer the shuffle
engine (core/shuffle_plan.py) consults per wide node.
"""
from __future__ import annotations

import contextlib
import pathlib
import threading
from typing import NamedTuple

_sweep = threading.local()
_priced = threading.local()
_open_recordings: list = []  # the recording_calls lists open in any thread
_open_lock = threading.Lock()
_fake_type = None

#: build directory for compiled kernels (listed in .gitignore)
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"


@contextlib.contextmanager
def sweeping():
    """Count launches inside the block as autotune launches."""
    prev = getattr(_sweep, "on", False)
    _sweep.on = True
    try:
        yield
    finally:
        _sweep.on = prev


class KernelCall(NamedTuple):
    """A kernel call priced on fake tensors: the operations of its work, the
    bytes it moves, the kernel's name, and how many calls it stands for
    (more than one inside a traced loop priced once: ``profile.cost.repeated``)."""

    flops: float
    bytes: float
    kernel: str
    count: int = 1


@contextlib.contextmanager
def recording_calls():
    """Collect the kernel calls made on fake tensors inside the block
    (``fake_call``) in the list it yields, as ``KernelCall``s."""
    prev = getattr(_priced, "calls", None)
    _priced.calls = calls = []
    with _open_lock:
        _open_recordings.append(calls)
    try:
        yield calls
    finally:
        _priced.calls = prev
        with _open_lock:
            _open_recordings.remove(calls)


def _recording():
    """The list a kernel call on fake tensors is recorded in: this thread's
    ``recording_calls``, or, on a thread that opened none (autograd runs a
    CUDA graph's backward on a thread of its own), the one recording open
    in the process."""
    calls = getattr(_priced, "calls", None)
    if calls is None:
        with _open_lock:
            if len(_open_recordings) == 1:
                calls = _open_recordings[0]
    return calls


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor (shapes, dtype and device, no data)."""
    global _fake_type
    if _fake_type is None:
        from torch._subclasses.fake_tensor import FakeTensor

        _fake_type = FakeTensor
    return isinstance(t, _fake_type)


def fake_call(operands, results, flops: float, kernel: str):
    """A call of ``kernel`` on fake tensors: nothing runs and no launch is
    counted. ``results`` (fresh tensors of the kernel's result shapes) are
    returned, and inside ``recording_calls`` the call is recorded with the
    operations of its work and its bytes: each operand read once and each
    result written once."""
    calls = _recording()
    if calls is not None:
        calls.append(KernelCall(float(flops), float(sum(t.numel() * t.element_size()
                                                        for t in (*operands, *results))),
                                kernel))
    return results


def count_launch(fn, geometry: tuple, variant: str | None = None) -> None:
    """Record one kernel launch on the dispatching function ``fn``, and
    outside sweeps the launch's geometry (shapes and static arguments) in
    ``fn.geometries`` so a caller can replay the shapes a path used, and
    the launch under its ``variant`` (the kernel route the wrapper chose) in
    ``fn.launches_by_variant`` (inside ``uncounted``, on its thread, the
    launch and its route are taken aside instead)."""
    if getattr(_sweep, "on", False):
        fn.tune_launches += 1
        return
    fn.geometries.add(geometry)
    taken = getattr(_sweep, "taken", None)
    if taken is None:
        fn.launches += 1
        by = fn.launches_by_variant
    else:
        counts = taken.setdefault(fn, [0, {}])
        counts[0] += 1
        by = counts[1]
    if variant is not None:
        by[variant] = by.get(variant, 0) + 1


def counted(fn):
    """Give a dispatching function its launch counters."""
    fn.launches = 0
    fn.tune_launches = 0
    fn.geometries = set()
    fn.launches_by_variant = {}
    return fn


def require_cuda(*tensors) -> None:
    """Kernel launch precondition: contiguous CUDA tensors on one device."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"kernel operands must share one CUDA device, got "
                             f"{[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


def next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def threads_for(block: int) -> int:
    """Threads per block of the look-back kernels (the scans, the bucket
    router) for ``block``: a power of two in [32, 512]."""
    return min(512, max(32, next_pow2(block)))


def launch_counters() -> dict:
    """``{kernel name: dispatching function}`` for every kernel, and the
    dropless MoE's grouped expert products (``moe_experts``: PyTorch's
    grouped GEMM, not a kernel of the port, counted per call on the card)."""
    from repro_torch.kernels.decode_attention.decode_attention import decode_attention_fwd
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)
    from repro_torch.kernels.moe_route.moe_route import moe_route_fwd
    from repro_torch.kernels.moe_route.route import bucket_route_fwd
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_reduce_fwd
    from repro_torch.kernels.ssd_scan.prefix import prefix_scan_fwd
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_fwd
    from repro_torch.kernels.moe_experts import grouped_experts

    return {"segment_reduce": segment_reduce_fwd,
            "prefix_scan": prefix_scan_fwd,
            "bucket_route": bucket_route_fwd,
            "flash_attention": flash_attention_fwd,
            "flash_attention_bwd": flash_attention_bwd,
            "decode_attention": decode_attention_fwd,
            "ssd_scan": ssd_scan_fwd,
            "moe_route": moe_route_fwd,
            "moe_experts": grouped_experts}


@contextlib.contextmanager
def uncounted():
    """Inside the block, the launches this thread makes are not counted on
    the kernels' counters but taken aside into the dict the block yields,
    ``{kernel name: (launches, {route: launches})}`` once the block ends
    (other threads count as ever; the geometries are recorded as ever): a
    CUDA graph's capture runs nothing, and ``credit_launches`` counts what
    it took at each replay."""
    prev = getattr(_sweep, "taken", None)
    _sweep.taken, out = {}, {}
    try:
        yield out
    finally:
        taken, _sweep.taken = _sweep.taken, prev
        names = {f: k for k, f in launch_counters().items()}
        out.update({names[f]: (n, by) for f, (n, by) in taken.items()})


def credit_launches(counts: dict) -> None:
    """Count ``counts`` (as ``uncounted`` takes them) on the kernels'
    counters: the launches of one replay of a captured graph."""
    fns = launch_counters()
    for k, (n, by) in counts.items():
        f = fns[k]
        f.launches += n
        for v, c in by.items():
            f.launches_by_variant[v] = f.launches_by_variant.get(v, 0) + c


def reset_launches() -> None:
    for fn in launch_counters().values():
        fn.launches = 0
        fn.tune_launches = 0
        fn.geometries = set()
        fn.launches_by_variant = {}

