"""What every cell of the benchmark shares: where the checkout is, seeds,
the table of peaks, the host clock's spans, the reading of a device trace,
the guard against the JAX package, and the result line.

Nothing here imports the program (``repro_torch``); the drivers do, inside
their functions.
"""
from __future__ import annotations

import json
import os
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level module names that may not be loaded in a run's process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")

#: the published peaks of the cards the benchmark runs on (NVIDIA's data
#: sheet, SXM part, dense rates, at the full power limit); a card whose name
#: matches no entry gets no share of a peak
PEAKS = (
    {"match": "H100", "bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
)


def peaks_for(device_name: str):
    for p in PEAKS:
        if p["match"] in device_name:
            return p
    return None


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def seed_of(seed: int, *tags) -> int:
    """A 63-bit seed derived from the run's ``--seed`` and ``tags``: the same
    arguments give the same number, any non-negative seed is taken."""
    import zlib

    import numpy as np

    words = [int(seed) % (1 << 64)] + [zlib.crc32(str(t).encode()) for t in tags]
    lo, hi = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(hi) << 31) | (int(lo) >> 1)


def process_env() -> None:
    """Set the run's environment before torch is imported: every build and
    kernel cache at a fixed directory inside the checkout (listed in
    .gitignore), so only a checkout's first run builds; one CPU thread for
    torch's and numpy's pools, so the host-bound loops share the cores with
    no idle pool spinning; JAX kept out of any library that would load it."""
    base = ROOT / "build" / "chipbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        d = base / sub
        d.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(d)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_loaded() -> list:
    """The forbidden top-level names present in ``sys.modules``, compared
    whole (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


class Spans:
    """Host-clock spans of the benchmark's own calls into the program:
    ``{name: [(seconds, attributes), ...]}``."""

    def __init__(self):
        self.spans: dict[str, list] = {}

    def add(self, name: str, seconds: float, **attrs):
        self.spans.setdefault(name, []).append((seconds, attrs))

    def durations(self, name: str) -> list:
        return [s for s, _ in self.spans.get(name, [])]


def now() -> float:
    return time.perf_counter()


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0–100) by nearest rank: the smallest value
    with at least ``q`` % of the values at or below it (``inf`` entries, the
    failed, sort last)."""
    import math

    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


# ---------------------------------------------------------------------------
# device trace
# ---------------------------------------------------------------------------


class DeviceTrace:
    """``torch.profiler``'s CUDA activity over a window of host time:
    ``busy_s`` is the union of the device's operations (kernels, copies,
    memsets) in seconds, ``window_s`` the window's host wall, ``ops`` the
    device seconds and launches by operation name, ``gaps`` the idle gaps
    between operations, each named by the operations around it."""

    def __init__(self):
        self.busy_s = None
        self.window_s = None
        self.ops: dict[str, list] = {}
        self.gaps: list = []

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = now()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.window_s = now() - self._t0
        self._prof.__exit__(*exc)
        return False

    def read(self):
        """Reduce the profiler's events (after the window: it takes a while)."""
        from torch.autograd import DeviceType

        prof, self._prof = self._prof, None
        if prof is None:
            return self

        ivs = []
        for e in prof.events():
            if getattr(e, "device_type", None) != DeviceType.CUDA:
                continue
            t0, t1 = e.time_range.start, e.time_range.end
            if t1 <= t0:
                continue
            name = short_kernel_name(e.name)
            ivs.append((t0, t1, name))
            rec = self.ops.setdefault(name, [0.0, 0])
            rec[0] += (t1 - t0) / 1e6
            rec[1] += 1
        ivs.sort()
        busy, gaps = 0.0, []
        cur0 = cur1 = None
        prev = None
        for t0, t1, name in ivs:
            if cur1 is None or t0 > cur1:
                if cur1 is not None:
                    busy += cur1 - cur0
                    gaps.append(((t0 - cur1) / 1e6, f"{prev} -> {name}"))
                cur0, cur1 = t0, t1
            else:
                cur1 = max(cur1, t1)
            prev = name
        if cur1 is not None:
            busy += cur1 - cur0
        self.busy_s = busy / 1e6 if ivs else None
        gaps.sort(reverse=True)
        self.gaps = gaps
        return self

    def kernel_seconds(self, pred) -> tuple:
        """(device seconds, launches) of the operations whose name passes
        ``pred``."""
        s = n = 0
        for name, (sec, count) in self.ops.items():
            if pred(name):
                s += sec
                n += count
        return s, n

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: kv[1][0], reverse=True)[:10]
        gaps: dict[str, float] = {}
        for sec, name in self.gaps:
            gaps[name] = gaps.get(name, 0.0) + sec
        top_gaps = sorted(gaps.items(), key=lambda kv: kv[1], reverse=True)[:10]
        return {"device_ops": [[k, v[0]] for k, v in top],
                "idle_gaps": [[k, v] for k, v in top_gaps]}


class TracedWindow:
    """Traces iterations ``[first, last)`` of a window on the card: the
    profiler's CUDA activity (``out.trace``) and the launches the port's
    kernels counted there (``out.traced["launches"]``)."""

    def __init__(self, on: bool, first: int, last: int):
        self.on, self.first, self.last = on, first, last
        self.active = False

    def before(self, n: int) -> None:
        if self.on and n == self.first:
            from repro_torch import kernels as K

            self._launches = {k: f.launches for k, f in K.launch_counters().items()}
            self._tracer = DeviceTrace().__enter__()
            self.active = True

    def after(self, n: int, out) -> None:
        if self.active and n + 1 == self.last:
            self.close(out)

    def close(self, out) -> None:
        """End the trace (also where the window closed inside it)."""
        if not self.active:
            return
        from repro_torch import kernels as K

        self._tracer.__exit__(None, None, None)
        self.active = False
        out.trace = self._tracer
        out.traced = {"launches": {k: f.launches - self._launches[k]
                                   for k, f in K.launch_counters().items()}}


def short_kernel_name(name: str) -> str:
    """A kernel's name without its return type, namespaces and template
    arguments ("void ns::flash_fwd_wgmma<...>(...)" -> "flash_fwd_wgmma")."""
    if name.startswith(("Memcpy", "Memset")):
        return " ".join(name.split()[:2])
    key = name.replace("(anonymous namespace)::", "")
    base = key.split("(")[0].split("<")[0].strip()
    base = base.split()[-1] if base.split() else base
    return base.split("::")[-1][:120] or name[:120]


# ---------------------------------------------------------------------------
# the result line
# ---------------------------------------------------------------------------


def result_line(correct, attempted, failed, metrics, device, checks, breakdown=None) -> str:
    """The run's last line of standard output: the driver's keys, then the
    numbers compared, each beside its limit, under ``checks``, last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


# ---------------------------------------------------------------------------
# what a driver hands back
# ---------------------------------------------------------------------------


class Outcome:
    """A run as its driver saw it: the end-to-end values (``metrics``), the
    requests or steps attempted and failed in the window, and of the failed
    those that failed outright (``lost``: shed, or a loss not finite; a
    request still without a token at the close is failed, not lost), the
    comparison's numbers, the device's peak memory, and for the per-layer
    readers the benchmark's spans, the traced window and what the program
    counted in it."""

    def __init__(self, config, traffic, spans, t_start):
        self.config, self.traffic, self.spans = config, traffic, spans
        self.t_start = t_start  # the process's start: set-up is timed from it
        self.metrics: dict = {}
        self.attempted = self.failed = self.lost = 0
        self.numbers: dict = {}
        self.memory_peak = 0
        self.trace = None  # DeviceTrace of the traced window
        self.traced: dict = {}  # the launches the port counted in it
        self.peaks = None
