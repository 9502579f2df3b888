"""Calibrating DeviceParams against the machine actually running (the port
of ``repro.profile.calibration``; docs/profiling.md §calibration).

The static defaults in ``cost.DeviceParams`` are order-of-magnitude CPU
figures; three cheap microprobes replace them with measured sustained rates
(a square f32 matmul for flops/s, a one-kernel copy-scale for HBM bytes/s,
a one-element kernel for the per-call cost), and ``fit_from_trace`` closes
the remaining gap by rescaling predictions against a captured trace's
observed stage durations. Probes run on the port's device — the card
unless the caller asks for the CPU — and every timed call ends in a
``torch.cuda.synchronize()`` there, as the reference's ends in
``block_until_ready``. The matmul runs in f32 at whatever
``torch.backends.cuda.matmul`` allows (torch's default keeps TF32 off)."""
from __future__ import annotations

import time

from repro_torch.profile.cost import CostModel, DeviceParams


def _time_best(fn, repeats: int = 3) -> float:
    """Best-of-N wall time of ``fn()`` — best, not mean, because probe
    noise is one-sided (GC, scheduler preemption only ever add time)."""
    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def calibrate(n: int = 512, repeats: int = 3, device: str = "cuda") -> DeviceParams:
    """Measured DeviceParams for ``device``.

    The probes: ``a @ b`` on two (n, n) f32 matrices; ``torch.mul(a, 2.0,
    out=c)``, one elementwise kernel that reads n² f32 and writes n²; and
    the ``nop``, ``torch.add(one, 1.0, out=one)`` on a one-element tensor —
    exactly one small elementwise kernel, the per-call cost that the
    fusion policy's ``dispatch_s`` stands for (the reference's ``nop`` is a
    jitted identity, which in eager torch would launch nothing)."""
    import torch

    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    a = torch.ones((n, n), dtype=torch.float32, device=dev)
    b = torch.ones((n, n), dtype=torch.float32, device=dev)
    c = torch.empty_like(a)
    one = torch.zeros(1, dtype=torch.float32, device=dev)

    def mm():
        torch.mm(a, b, out=c)
        sync()

    def cp():
        torch.mul(a, 2.0, out=c)
        sync()

    def nop():
        torch.add(one, 1.0, out=one)
        sync()

    for probe in (mm, cp, nop):  # warm: library handles, allocations
        probe()
    t_mm = _time_best(mm, repeats)
    t_cp = _time_best(cp, repeats)
    t_nop = _time_best(nop, repeats)

    flops = 2.0 * n * n * n
    # copy-scale touches in + out once each: 2 arrays of n*n f32
    hbm_bytes = 2.0 * n * n * 4
    return DeviceParams(
        flops_per_s=max(1e6, flops / max(1e-9, t_mm - t_nop)),
        hbm_bytes_per_s=max(1e6, hbm_bytes / max(1e-9, t_cp - t_nop)),
        dispatch_s=max(1e-6, t_nop),
    )


def calibrated_model(n: int = 512, repeats: int = 3, device: str = "cuda") -> CostModel:
    return CostModel(calibrate(n, repeats, device))


def fit_from_trace(model: CostModel, pairs) -> float:
    """Rescale ``model`` so predictions match observed (predicted_s,
    observed_s) pairs — thin alias of ``CostModel.fit`` kept here so the
    calibration surface is one module."""
    return model.fit(list(pairs))
