#!/usr/bin/env python3
"""Time the look-back kernels of one tree of the torch port (the segmented
scan, the prefix scan, the bucket router and the MoE router) on one NVIDIA
card, at the shapes of ``chip_smoke.py``'s main paths.

    PYTHONPATH=src python3 tools/time_lookback_kernels.py [--src DIR] [--reps N]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's), so two trees can be compared in one session on
one card: run the script once per tree, in turns (A, B, B, A). Each run
builds its kernels, holds them against their plain versions, and prints one
JSON line:

- ``segment_reduce`` at (2^27, 1) int32, op max, 5 % boundaries (the hybrid
  ``reduceByKey(max)`` post hook's shape), at each ``block`` the autotune
  sweeps by default (``ms_by_block``), the fastest reported as ``ms``;
- ``prefix_scan`` at 2^27 int32, op min (``segment_totals``' last-row
  gather), forward at each ``block``, the fastest reported as ``ms``; also
  ``reverse_ms``, the public ``ops.prefix_scan(..., reverse=True)`` as
  ``segment_totals`` calls it (a tree whose kernel cannot scan from the
  tail flips around it), and ``sum_ms`` against ``cumsum_ms``
  (``torch.cumsum``);
- ``bucket_route`` at 2^20 rows, P = 64, capacity 20480 (the hybrid join's
  exchange), by device time at each ``block`` (``device_ms_by_block``; at
  this size CUDA events time the host's issue rate), the fastest reported;
- ``moe_route`` at (2048, 8) f32, k 2, capacity 568 (a Mixtral prefill) and
  at (4, 8), capacity 2 (a decode tick of 4 slots);

each with ``ms`` (CUDA events around back-to-back calls of the wrapper),
``device_ms`` (``torch.profiler``: the device time of the call's launches,
memsets included; per launch, and launches per call, in
``device_ms_by_launch``) and, for the two routers, ``host_us``
(``time.perf_counter`` over ``--host-calls`` calls of the wrapper, without a
synchronize inside the loop: the host's time to issue one call), measured
by ``chip_smoke.py``'s helpers. ``block`` means what each tree's wrapper
makes of it (threads a block for the CUDA kernels).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402  (its timing helpers; it imports no repro_torch here)
#: the registry's default autotune candidates (``ignis.kernels.blocks``)
BLOCKS = (128, 256, 512)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--host-calls", type=int, default=2000)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))  # before chip_smoke's own src

    import torch

    if not torch.cuda.is_available():
        print("time_lookback_kernels: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.moe_route.moe_route import moe_route_fwd
    from repro_torch.kernels.moe_route.ref import bucket_route_ref, moe_route_ref
    from repro_torch.kernels.moe_route.route import bucket_route_fwd
    from repro_torch.kernels.segment_reduce.ref import segment_scan_plain
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_reduce_fwd
    from repro_torch.kernels.ssd_scan.ops import prefix_scan
    from repro_torch.kernels.ssd_scan.prefix import prefix_scan_fwd
    from repro_torch.kernels.ssd_scan.ref import prefix_scan_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"src": os.path.relpath(os.path.abspath(args.src), ROOT), "gpu": smi}

    n = 1 << 27
    v = torch.randint(-1000, 1000, (n, 1), generator=g, device="cuda", dtype=torch.int32)
    hb = torch.rand(n, generator=g, device="cuda") < 0.05
    hb[0] = True
    ref = segment_scan_plain(v, hb, "max")
    ms, ok = {}, True
    for block in BLOCKS:
        ok = ok and torch.equal(segment_reduce_fwd(v, hb, op="max", block=block), ref)
        ms[block] = cs.time_ms(lambda: segment_reduce_fwd(v, hb, op="max", block=block),
                               max(args.reps // 10, 10))
    best = min(ms, key=ms.get)
    call = lambda: segment_reduce_fwd(v, hb, op="max", block=best)  # noqa: E731
    out["segment_reduce"] = dict(shape=[n, 1], op="max", equal=ok, ms_by_block=ms, block=best,
                                 ms=ms[best], device_ms=cs.device_ms(call, 20),
                                 device_ms_by_launch=cs.device_profile(call, 20))
    del ref, v, hb

    x = torch.randint(0, n, (n,), generator=g, device="cuda", dtype=torch.int32)
    ref = prefix_scan_ref(x, "min")
    ms, ok = {}, True
    for block in BLOCKS:
        ok = ok and torch.equal(prefix_scan_fwd(x, op="min", block=block), ref)
        ms[block] = cs.time_ms(lambda: prefix_scan_fwd(x, op="min", block=block),
                               max(args.reps // 10, 10))
    best = min(ms, key=ms.get)
    call = lambda: prefix_scan_fwd(x, op="min", block=best)  # noqa: E731
    rev = lambda: prefix_scan(x, op="min", block=best, reverse=True)  # noqa: E731
    ok = ok and torch.equal(rev(), prefix_scan_ref(x, "min", reverse=True))
    ok = ok and torch.equal(prefix_scan_fwd(x, op="sum", block=best),
                            torch.cumsum(x, 0, dtype=x.dtype))
    out["prefix_scan"] = dict(
        shape=[n], op="min", equal=ok, ms_by_block=ms, block=best, ms=ms[best],
        device_ms=cs.device_ms(call, 20), device_ms_by_launch=cs.device_profile(call, 20),
        reverse_ms=cs.time_ms(rev, max(args.reps // 10, 10)),
        reverse_device_ms=cs.device_ms(rev, 20),
        sum_ms=cs.time_ms(lambda: prefix_scan_fwd(x, op="sum", block=best),
                          max(args.reps // 10, 10)),
        cumsum_ms=cs.time_ms(lambda: torch.cumsum(x, 0, dtype=x.dtype),
                             max(args.reps // 10, 10)))
    del ref, x

    n, P, C = 1 << 20, 64, 20480
    dest = torch.randint(0, P, (n,), generator=g, device="cuda", dtype=torch.int32)
    ref = bucket_route_ref(dest, P, C)
    ms, ok = {}, True
    for block in BLOCKS:
        got = bucket_route_fwd(dest, P, C, block=block)
        ok = ok and all(torch.equal(a, b) for a, b in zip(got, ref))
        ms[block] = cs.device_ms(lambda: bucket_route_fwd(dest, P, C, block=block), 50)
    best = min(ms, key=ms.get)
    call = lambda: bucket_route_fwd(dest, P, C, block=best)  # noqa: E731
    out["bucket_route"] = dict(shape=[n], p=P, capacity=C, equal=ok, device_ms_by_block=ms,
                               block=best, ms=cs.time_ms(call, args.reps),
                               device_ms=cs.device_ms(call, 50),
                               device_ms_by_launch=cs.device_profile(call, 50),
                               host_us=cs.host_us(call, args.host_calls))
    del ref, dest

    for T, C in ((2048, 568), (4, 2)):
        x = torch.randn((T, 8), generator=g, device="cuda")
        got, ref = moe_route_fwd(x, 2, C), moe_route_ref(x, 2, C)
        ok = (all(torch.equal(a, b) for a, b in zip(got[1:], ref[1:]))
              and float((got[0] - ref[0]).abs().max()) <= 1e-6)
        call = lambda: moe_route_fwd(x, 2, C)  # noqa: E731
        out[f"moe_route_{T}"] = dict(shape=[T, 8], k=2, capacity=C, equal=ok,
                                     ms=cs.time_ms(call, args.reps),
                                     device_ms=cs.device_ms(call, 50),
                                     device_ms_by_launch=cs.device_profile(call, 50),
                                     host_us=cs.host_us(call, args.host_calls))
    print(json.dumps(out))
    return 0 if all(v["equal"] for k, v in out.items() if isinstance(v, dict)) else 1


if __name__ == "__main__":
    sys.exit(main())
