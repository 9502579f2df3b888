#!/usr/bin/env python3
"""Time the segmented scan and the MoE router of one tree of the torch port
on one NVIDIA card, at the shapes of ``chip_smoke.py``'s main paths.

    PYTHONPATH=src python3 tools/time_lookback_kernels.py [--src DIR] [--reps N]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's), so two trees can be compared in one session on
one card: run the script once per tree, in turns (A, B, B, A). Each run
builds its kernels, holds them against their plain versions, and prints one
JSON line:

- ``segment_reduce`` at (2^27, 1) int32, op max, 5 % boundaries (the hybrid
  ``reduceByKey(max)`` post hook's shape), at each ``block`` the autotune
  sweeps by default (``ms_by_block``), the fastest reported as ``ms``;
- ``moe_route`` at (2048, 8) f32, k 2, capacity 568 (a Mixtral prefill) and
  at (4, 8), capacity 2 (a decode tick of 4 slots);

each with ``ms`` (CUDA events around back-to-back calls of the wrapper),
``device_ms`` (``torch.profiler``: the device time of the call's launches,
memsets included; per launch, and launches per call, in
``device_ms_by_launch``) and, for the router, ``host_us``
(``time.perf_counter`` over ``--host-calls`` calls of the wrapper, without a
synchronize inside the loop: the host's time to issue one call), measured
by ``chip_smoke.py``'s helpers.
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
    from repro_torch.kernels.moe_route.ref import moe_route_ref
    from repro_torch.kernels.segment_reduce.ref import segment_scan_plain
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_reduce_fwd

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
