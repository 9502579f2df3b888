"""The port's kernel registry: modes, describe(), the capability fault,
demote, builtin-op recognition and the autotune memo — the cases of
tests/test_kernel_conformance.py's registry block, on the torch port — plus
the port's one deliberate difference: on a CUDA worker a failed probe
raises instead of falling back to the plain path."""
import threading

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401 — the reference's registry imports through core
from repro.kernels.registry import KernelRegistry as JaxRegistry  # noqa: E402
from repro.kernels.registry import builtin_reduce_op as jax_builtin_reduce_op  # noqa: E402
from repro_torch.core import faults  # noqa: E402
from repro_torch.core.faults import FaultPlan  # noqa: E402
from repro_torch.kernels import registry as reg  # noqa: E402
from repro_torch.kernels.registry import KernelRegistry, builtin_reduce_op  # noqa: E402

_ZERO_STATS = {"kernel_hits": 0, "kernel_fallbacks": 0,
               "autotune_runs": 0, "autotune_evictions": 0}


def test_registry_rejects_unknown_mode():
    with pytest.raises(ValueError, match="ignis.kernels"):
        KernelRegistry(mode="sometimes")


def test_mode_off_always_falls_back():
    r = KernelRegistry(mode="off")
    assert r.select("segment_reduce") is None
    assert r.stats == {**_ZERO_STATS, "kernel_fallbacks": 1}


def test_mode_auto_falls_back_on_cpu():
    # the plain stand-in is no faster than the plain path: auto takes the
    # kernel tier only where it is compiled — as the reference's auto never
    # interprets off the TPU
    r = KernelRegistry(mode="auto", device="cpu")
    assert r.select("segment_reduce") is None and r.stats["kernel_fallbacks"] == 1


def test_mode_auto_selects_the_compiled_kernel_on_a_cuda_worker(monkeypatch):
    monkeypatch.setitem(reg._PROBES, "segment_reduce", lambda device: None)
    r = KernelRegistry(mode="auto", device="cuda")
    sel = r.select("segment_reduce")
    assert sel is not None and not sel.interpret
    assert sel.describe() == "segment_reduce[compiled]"


def test_mode_interpret_selects_interpreted_kernel():
    r = KernelRegistry(mode="interpret")
    sel = r.select("bucket_route")
    assert sel is not None and sel.interpret
    assert sel.describe() == "bucket_route[interpret]"
    assert r.stats["kernel_hits"] == 1


@pytest.mark.parametrize("device,interpret", [("cpu", True), ("cuda", False)])
def test_mode_on_uses_interpret_where_not_compiled(device, interpret, monkeypatch):
    monkeypatch.setitem(reg._PROBES, "prefix_scan", lambda device: None)
    r = KernelRegistry(mode="on", device=device)
    sel = r.select("prefix_scan")
    assert sel is not None and sel.interpret == interpret


def test_probe_failure_on_cpu_degrades_to_fallback(monkeypatch):
    def boom(device):
        raise RuntimeError("no such kernel here")

    monkeypatch.setitem(reg._PROBES, "segment_reduce", boom)
    r = KernelRegistry(mode="interpret")
    assert r.select("segment_reduce") is None
    assert r.stats["kernel_fallbacks"] == 1
    # the probe result is cached: a second select does not re-probe
    monkeypatch.setitem(reg._PROBES, "segment_reduce", lambda device: None)
    assert r.select("segment_reduce") is None


@pytest.mark.parametrize("mode", ["auto", "on", "interpret"])
def test_probe_failure_on_a_cuda_worker_raises(mode, monkeypatch):
    def boom(device):
        raise RuntimeError("nvcc build failed")

    monkeypatch.setitem(reg._PROBES, "bucket_route", boom)
    r = KernelRegistry(mode=mode, device="cuda")
    with pytest.raises(RuntimeError, match="nvcc build failed"):
        r.select("bucket_route")
    assert r.stats["kernel_fallbacks"] == 0 and r.stats["kernel_hits"] == 0


def test_capability_fault_degrades_without_error():
    r = KernelRegistry(mode="interpret")
    plan = FaultPlan().fail_kernel_capability("segment_reduce", times=1)
    with faults.inject(plan):
        assert r.select("segment_reduce") is None      # degraded
        assert r.select("segment_reduce") is not None  # times=1: recovered
    assert r.stats["kernel_fallbacks"] == 1 and r.stats["kernel_hits"] == 1


def test_demote_rebooks_hit_as_fallback():
    r = KernelRegistry(mode="interpret")
    assert r.select("prefix_scan") is not None
    r.demote()
    assert r.stats == {**_ZERO_STATS, "kernel_fallbacks": 1}


@pytest.mark.parametrize("mode", ["off", "interpret", "on"])
def test_describe_and_counters_read_as_the_reference(mode):
    a, b = KernelRegistry(mode=mode), JaxRegistry(mode=mode)
    for kernel in ("segment_reduce", "prefix_scan", "bucket_route"):
        sa, sb = a.select(kernel), b.select(kernel)
        assert (sa is None) == (sb is None)
        if sa is not None:
            assert sa.describe() == sb.describe()
    assert dict(a.stats) == dict(b.stats)
    assert a.describe() == b.describe()


# ---------------------------------------------------------------------------
# builtin-op recognition
# ---------------------------------------------------------------------------


def test_builtin_reduce_op_recognizes_builtins():
    v = torch.zeros(4, dtype=torch.int32)
    assert builtin_reduce_op(lambda a, b: a + b, 0, v) == "sum"
    assert builtin_reduce_op(torch.maximum, 0, v) == "max"
    assert builtin_reduce_op(torch.minimum, 0, v) == "min"
    assert builtin_reduce_op(lambda a, b: a + b, torch.tensor(0.0),
                             torch.zeros((4, 2))) == "sum"


_REJECTED = [
    lambda a, b: a + b + 1,     # extra op
    lambda a, b: a + 3,         # constant operand
    lambda a, b: a + a,         # ignores one argument
    lambda a, b: a * b,         # unsupported primitive
    lambda a, b: (a + b) / 2,   # dtype-changing chain
]


@pytest.mark.parametrize("i", range(len(_REJECTED)))
def test_builtin_reduce_op_rejects_non_builtins_as_the_reference(i):
    fn = _REJECTED[i]
    assert builtin_reduce_op(fn, 0, torch.zeros(4, dtype=torch.int32)) is None
    assert jax_builtin_reduce_op(fn, jnp.int32(0), jnp.zeros(4, jnp.int32)) is None


@pytest.mark.parametrize("fn", ["add", "max", "min"])
def test_builtin_reduce_op_agrees_with_the_reference(fn):
    tfn = {"add": lambda a, b: a + b, "max": torch.maximum, "min": torch.minimum}[fn]
    jfn = {"add": lambda a, b: a + b, "max": jnp.maximum, "min": jnp.minimum}[fn]
    for dtype in ("int32", "float32"):
        assert (builtin_reduce_op(tfn, 0, torch.zeros(4, dtype=getattr(torch, dtype)))
                == jax_builtin_reduce_op(jfn, 0, jnp.zeros(4, dtype)))


def test_builtin_reduce_op_rejects_unsupported_values():
    add = lambda a, b: a + b  # noqa: E731
    assert builtin_reduce_op(add, 0.0, torch.zeros(4, dtype=torch.float16)) is None
    assert builtin_reduce_op(  # tree value: not a single leaf
        add, 0, {"a": torch.zeros(4, dtype=torch.int32),
                 "b": torch.zeros(4, dtype=torch.int32)}) is None
    assert builtin_reduce_op(  # non-scalar identity
        add, torch.zeros(2, dtype=torch.int32), torch.zeros(4, dtype=torch.int32)) is None
    assert builtin_reduce_op(  # ndim > 2
        add, 0, torch.zeros((4, 2, 2), dtype=torch.int32)) is None


# ---------------------------------------------------------------------------
# autotune memo
# ---------------------------------------------------------------------------


def test_tune_memoises_per_key():
    r = KernelRegistry(mode="interpret")
    calls = []
    best = r.tune(("k", 1), (128, 256), lambda b: calls.append(b) or b * 1e-6)
    assert best == 128 and calls == [128, 256]
    assert r.tune(("k", 1), (128, 256), lambda b: 1 / 0) == 128  # memo hit
    assert r.stats["autotune_runs"] == 1


def test_tune_single_candidate_skips_timing():
    r = KernelRegistry(mode="interpret")
    assert r.tune(("k",), (256,), lambda b: 1 / 0) == 256
    assert r.stats["autotune_runs"] == 1


def test_tune_eviction_retunes_exactly_once():
    r = KernelRegistry(mode="interpret", tune_cache_size=1)
    timer = lambda b: float(b)  # noqa: E731
    for key in (("A",), ("B",), ("A",)):
        r.tune(key, (64, 128), timer)
    assert r.stats["autotune_runs"] == 3
    assert r.stats["autotune_evictions"] == 2
    assert r.tune(("A",), (64, 128), timer) == 64
    assert r.stats["autotune_runs"] == 3


def test_concurrent_misses_on_one_key_cost_one_sweep():
    r = KernelRegistry(mode="interpret")
    calls, gate = [], threading.Event()

    def timer(b):
        calls.append(b)
        gate.wait(5)
        return float(b)

    threads = [threading.Thread(target=r.tune, args=(("hot",), (64, 128), timer))
               for _ in range(6)]
    for t in threads:
        t.start()
    while not calls:
        pass
    gate.set()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert r.stats["autotune_runs"] == 1
    assert sorted(calls) == [64, 128]


def test_failed_sweep_raises_and_unparks_waiters():
    r = KernelRegistry(mode="interpret")
    with pytest.raises(ZeroDivisionError):
        r.tune(("bad",), (64, 128), lambda b: 1 / 0)
    assert r.tune(("bad",), (64, 128), lambda b: float(b)) == 64
    assert r.stats["autotune_runs"] == 1


def test_sweep_launches_are_counted_apart():
    from repro_torch import kernels

    kernels.reset_launches()
    fn = kernels.launch_counters()["prefix_scan"]
    with kernels.sweeping():
        kernels.count_launch(fn, ((8,), "min"))
    kernels.count_launch(fn, ((16,), "min"))
    assert (fn.launches, fn.tune_launches) == (1, 1)
    assert fn.geometries == {((16,), "min")}
    kernels.reset_launches()
