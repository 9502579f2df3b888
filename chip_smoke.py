#!/usr/bin/env python3
"""Smoke run of the torch port (``src/repro_torch``) on one NVIDIA card.

Drives the port's main path — the paper's hybrid wordcount on ``p = 8``
virtual executor ranks — through the entry points a user calls, holds every
hand-written kernel against its plain torch version at the shapes that path
gave it, and reports. Run from the repository root:

    PYTHONPATH=src python3 chip_smoke.py          # N = 2^26 words, p = 8

Phases (each prints its lines; any failure exits non-zero):

1. build   — first launch of each Triton kernel (the kernels package
             caches builds under ``build/kernels/triton`` unless
             TRITON_CACHE_DIR says otherwise);
2. main    — the hybrid job, twice with ``ignis.kernels=auto`` (launch
             counters reset before each run) and once with ``off``: branch A
             ``map → reduceByKey(add)`` and ``reduceByKey(max)`` (PSRS sort
             stages whose post hook runs the segment and prefix kernels; the
             max is over a random int32 mark per word),
             branch B ``compact → join`` against a 2^20-row dimension table
             (a hash exchange on both sides: the bucket-route kernel), branch
             C the native ``wordcount`` app; A and C (and B) are submitted
             into one IJob. Checks: word counts equal ``np.bincount``, the
             per-word maxima equal a numpy oracle, every collected frame of
             the kernel runs equals the ``off`` run bit for bit and row for
             row in the order it came back, no fallback, no overflow retry
             and no new wide plan on the second run. Each run also reports
             the wall time spent in ``to_host`` (the driver-side conversion
             of collected blocks to row trees) and in autotune sweeps;
3. kernels — each kernel against its plain version on the card at the
             main path's largest shape and at edge cases (integers bit for
             bit; float sums within a stated tolerance), timed with CUDA
             events beside its bound and, where one exists, the library call.

The last two lines are the ``kernels`` JSON object (with the card's name and
power limit just before it) and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
VOCAB = 1 << 20


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


_T0 = time.perf_counter()


def log(*a):
    print(f"[{time.perf_counter() - _T0:7.1f} s]", *a, flush=True)


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------


def register_wordcount():
    """The native SPMD app of the hybrid wordcount: a histogram over every
    rank's rows (the torch twin of examples/quickstart.py's app)."""
    import torch

    from repro_torch.core.native import ignis_export

    @ignis_export("wordcount")
    def wordcount(ctx, data=None, valid=None):
        vocab = int(ctx.var("vocab"))
        words = data["word"]
        ids = torch.where(valid, words, vocab).long()
        counts = torch.bincount(ids, minlength=vocab + 1)[:-1].to(torch.int32)
        keys = torch.arange(vocab, dtype=torch.int32, device=words.device)
        return {"key": keys, "value": counts}, counts > 0


def hybrid(w, words, marks, dim_keys, dim_vals):
    import torch

    src = w.parallelize({"word": words, "mark": marks})
    counts = (src.map(lambda r: {"key": r["word"], "value": 1})
              .reduce_by_key(lambda a, b: a + b, 0))
    maxes = (src.map(lambda r: {"key": r["word"], "value": r["mark"]})
             .reduce_by_key(torch.maximum, 0))
    dim = w.parallelize({"key": dim_keys, "value": dim_vals})
    joined = counts.compact().join(dim)
    native = w.call("wordcount", src, vocab=VOCAB)
    return counts, maxes, joined, native


class Spans:
    """Wall-clock intervals (``perf_counter``) of one kind of work, which
    may overlap across the job's threads."""

    def __init__(self):
        self.lock = threading.Lock()
        self.iv = []

    def add(self, t0, t1):
        with self.lock:
            self.iv.append((t0, t1))

    def take(self):
        """(calls, ms of wall covered by at least one interval, summed ms),
        and start afresh."""
        with self.lock:
            iv, self.iv = sorted(self.iv), []
        covered, end = 0.0, float("-inf")
        for a, b in iv:
            if b > end:
                covered += b - max(a, end)
                end = b
        return len(iv), covered * 1e3, sum(b - a for a, b in iv) * 1e3


TO_HOST, SWEEPS = Spans(), Spans()


def instrument():
    """Time two parts of each job with ``perf_counter``: ``to_host`` (the
    driver boundary of collect: blocks to host row trees) after the device
    has finished the work queued before it, and the kernel registry's
    sweeping blocks (capability probes and autotune sweeps)."""
    import contextlib

    import torch

    from repro_torch.core import dataframe
    from repro_torch.kernels import registry

    to_host, sweeping = dataframe.to_host, registry.sweeping

    def timed_to_host(block):
        torch.cuda.synchronize()  # what follows is the host's work
        t0 = time.perf_counter()
        out = to_host(block)
        TO_HOST.add(t0, time.perf_counter())
        return out

    @contextlib.contextmanager
    def timed_sweeping():
        t0 = time.perf_counter()
        with sweeping():
            yield
        SWEEPS.add(t0, time.perf_counter())

    dataframe.to_host = timed_to_host
    registry.sweeping = timed_sweeping


def run_job(frames, label):
    import torch

    from repro_torch.core import IJob

    counts, maxes, joined, native = frames
    torch.cuda.reset_peak_memory_stats()
    TO_HOST.take(), SWEEPS.take()
    job = IJob(label)
    t0 = time.perf_counter()
    futs = {
        "counts.collect": counts.collect_async(job=job),
        "native.collect": native.collect_async(job=job),
        "maxes.collect": maxes.collect_async(job=job),
        "join.count": joined.count_async(job=job),
    }
    out = {k: f.result() for k, f in futs.items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    walls = {k: round(f.task.duration_ms, 3) for k, f in futs.items()}
    th, sw = TO_HOST.take(), SWEEPS.take()
    log(f"main[{label}]: job wall {wall * 1e3:.1f} ms; action task ms {walls}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"main[{label}]: to_host {th[0]} calls cover {th[1]:.1f} ms of the job "
        f"wall ({th[2]:.1f} ms summed over threads); sweeps {sw[0]} cover "
        f"{sw[1]:.1f} ms ({sw[2]:.1f} ms summed)")
    return out


def kv_arrays(rows):
    """Collected ``{key, value}`` rows as two int64 arrays in the order the
    rows came back; the row dtypes are checked on the way (int32, as the
    reference's)."""
    import numpy as np

    check(all(r["key"].dtype == np.int32 and r["value"].dtype == np.int32
              for r in rows), "collected rows are not int32")
    k = np.fromiter((int(r["key"]) for r in rows), np.int64, len(rows))
    v = np.fromiter((int(r["value"]) for r in rows), np.int64, len(rows))
    return k, v


def by_key(k, v):
    import numpy as np

    order = np.argsort(k, kind="stable")
    return k[order], v[order]


def main_path(args):
    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.core import ICluster, IProperties, IWorker

    n = 1 << args.log2n
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    words = (rng.zipf(1.1, n) % VOCAB).astype(np.int32)
    marks = rng.integers(0, 2**31 - 1, n, dtype=np.int32)
    dim_keys = np.arange(VOCAB, dtype=np.int32)
    dim_vals = ((dim_keys.astype(np.int64) * 2654435761) % 1000003).astype(np.int32)
    exp = np.bincount(words, minlength=VOCAB)
    nz = np.nonzero(exp)[0]
    # the numpy oracle of reduceByKey(max): sort (word, mark) pairs; each
    # word's largest mark ends its run
    pairs = np.sort((words.astype(np.int64) << 31) | marks)
    exp_max = pairs[np.cumsum(exp)[nz] - 1] & (2**31 - 1)
    del pairs
    log(f"main: N={n} words (zipf 1.1 mod 2^20) with random int32 marks, "
        f"p={args.p}, {len(nz)} distinct; data and oracles made in "
        f"{time.perf_counter() - t0:.1f} s")
    register_wordcount()
    instrument()

    def worker(mode):
        return IWorker(ICluster(IProperties({
            "ignis.device": "cuda", "ignis.executor.instances": str(args.p),
            "ignis.kernels": mode})), "python")

    w = worker("auto")
    frames = hybrid(w, words, marks, dim_keys, dim_vals)
    results, launches = [], []
    for run in (1, 2):
        before = w.metrics()
        K.reset_launches()
        results.append(run_job(frames, f"auto run {run}"))
        fns = K.launch_counters()
        launches.append({k: (f.launches, f.tune_launches, sorted(f.geometries))
                         for k, f in fns.items()})
        after = w.metrics()
        log(f"main[auto run {run}]: launches "
            f"{ {k: v[0] for k, v in launches[-1].items()} } "
            f"(autotune sweeps apart: { {k: v[1] for k, v in launches[-1].items()} })")
        for k, (cnt, _t, _g) in launches[-1].items():
            check(cnt > 0, f"run {run}: kernel {k} was never launched")
        check(after["kernels"]["kernel_fallbacks"] == 0, "a kernel fell back")
        if run == 2:
            d_retry = (after["shuffle"]["overflow_retries"]
                       - before["shuffle"]["overflow_retries"])
            d_plans = (after["shuffle"]["wide_plan_misses"]
                       - before["shuffle"]["wide_plan_misses"])
            log(f"main[auto run 2]: new overflow_retries={d_retry}, "
                f"new wide_plan_misses={d_plans}")
            check(d_retry == 0, "overflow retries on the repeated run")
            check(d_plans == 0, "new wide-plan compiles on the repeated run")
    log(f"main: shuffle {w.metrics('shuffle')}")
    log(f"main: kernels {w.metrics('kernels')}")

    off = run_job(hybrid(worker("off"), words, marks, dim_keys, dim_vals), "off")

    # correctness: each frame against its numpy oracle (rows sorted by key),
    # and the kernel runs against off row for row in the order they came back
    oracle = {"counts.collect": exp[nz], "native.collect": exp[nz],
              "maxes.collect": exp_max}
    rows = {label: {key: kv_arrays(v) if isinstance(v, list) else v
                    for key, v in res.items()}
            for label, res in (("auto 1", results[0]), ("auto 2", results[1]),
                               ("off", off))}
    for label, res in rows.items():
        for key, want in oracle.items():
            k, v = by_key(*res[key])
            check(np.array_equal(k, nz) and np.array_equal(v, want),
                  f"{label}: {key} differs from its numpy oracle")
        check(res["join.count"] == len(nz), f"{label}: join rows")
    for label in ("auto 1", "auto 2"):
        for key, want in rows["off"].items():
            got = rows[label][key]
            same = (all(np.array_equal(a, b) for a, b in zip(got, want))
                    if isinstance(want, tuple) else got == want)
            check(same, f"{label}: {key} differs from the ignis.kernels=off run")
    log("main: counts == np.bincount, native == np.bincount, maxes == numpy "
        "oracle, kernel runs == off (bit for bit, row for row in collected "
        "order), join rows == distinct words: OK")
    return launches[0]


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a, b) -> float:
    import torch

    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def exact(a, b, what):
    import torch

    check(a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b),
          f"{what}: kernel differs from its plain version")


class _Rand:
    """Seeded inputs on the card."""

    def __init__(self, seed: int):
        import torch

        self.dev = torch.device("cuda")
        self.g = torch.Generator(device=self.dev)
        self.g.manual_seed(seed)

    def ints(self, n, lo=-1000, hi=1000, shape=None):
        import torch

        return torch.randint(lo, hi, shape or (n,), generator=self.g,
                             device=self.dev, dtype=torch.int32)

    def rand(self, *shape):
        import torch

        return torch.rand(shape, generator=self.g, device=self.dev)


def edge_checks():
    """Every kernel against its plain version at edge shapes: ragged N
    (not a block multiple), N = 0 and 1, D in {1, 4}, every op, int32 / f32
    / bool, a non-zero identity at invalid rows, the flat multi-rank layout,
    all rows to one destination, C below the demand, several scan levels.
    Integers and integer-valued f32 bit for bit; random f32 sums within
    rtol 1e-5 (the association order differs)."""
    import torch

    from repro_torch.core.shuffle import segmented_reduce
    from repro_torch.kernels.moe_route.ops import bucket_route
    from repro_torch.kernels.moe_route.ref import bucket_route_ref
    from repro_torch.kernels.segment_reduce.ops import segment_reduce, segment_totals
    from repro_torch.kernels.segment_reduce.ref import segment_reduce_ref
    from repro_torch.kernels.ssd_scan.ops import prefix_scan
    from repro_torch.kernels.ssd_scan.ref import prefix_scan_ref

    r = _Rand(1)
    fns = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}
    for o in ("sum", "max", "min"):
        for nn, dd, dt in ((1, 1, torch.int32), (1000, 4, torch.int32),
                           (4097, 1, torch.int32), (70001, 4, torch.float32),
                           (300000, 1, torch.int32)):
            keys = torch.sort(r.ints(nn, 0, max(nn // 7, 1))).values
            valid = r.rand(nn) < 0.8
            vals = r.ints(nn, -50, 50, (nn, dd)).to(dt)  # integer-valued: exact
            hk, sk = segment_reduce(keys, valid, vals, op=o, block=128)
            hr, sr = segment_reduce_ref(keys, valid, vals, op=o)
            exact(hk, hr, f"segment_reduce heads n={nn} {o}")
            exact(sk, sr, f"segment_reduce n={nn} d={dd} {dt} {o}")
            seg = max(nn // 8, 1)
            ident = torch.tensor(41, dtype=dt, device=r.dev)
            _, tk = segment_totals(keys, valid, vals, o, ident, block=128, seg=seg)
            _, tr = segmented_reduce(keys, valid, vals, fns[o], ident, seg=seg)
            exact(tk, tr, f"segment_totals n={nn} {o} (rank-flat seg={seg}, identity 41)")
    z = torch.zeros(0, dtype=torch.int32, device=r.dev)
    h, t = segment_totals(z, z.bool(), z, "sum", 0)
    check(h.shape == (0,) and t.shape == (0,), "segment_totals on N = 0")
    fv = r.rand(70001, 4)
    keys = torch.sort(r.ints(70001, 0, 500)).values
    valid = torch.ones(70001, dtype=torch.bool, device=r.dev)
    _, sk = segment_reduce(keys, valid, fv, op="sum", block=256)
    _, sr = segment_reduce_ref(keys, valid, fv, op="sum")
    check(torch.allclose(sk, sr, rtol=1e-5, atol=1e-4),
          "segment_reduce random f32 sums beyond rtol 1e-5, atol 1e-4")
    log("edge: segment_reduce / segment_totals — ops x {i32, f32} x "
        "N {1, 1000, 4097, 70001, 300000} x D {1, 4}, rank-flat seg, N=0: OK")

    for o in ("sum", "max", "min"):
        for nn in (0, 1, 5, 513, 100003, 3000001):
            for dt in ("int32", "bool"):
                xx = r.ints(nn) if dt == "int32" else r.ints(nn, 0, 2) == 0
                for rev in (False, True):
                    exact(prefix_scan(xx, op=o, block=64, reverse=rev),
                          prefix_scan_ref(xx, op=o, reverse=rev),
                          f"prefix_scan n={nn} {dt} {o} reverse={rev}")
    xf = r.rand(100003)
    check(torch.allclose(prefix_scan(xf, op="sum"),
                         prefix_scan_ref(xf, "sum"), rtol=1e-5, atol=1e-3),
          "prefix_scan random f32 sums beyond rtol 1e-5, atol 1e-3")
    log("edge: prefix_scan — ops x {i32, bool} x N {0, 1, 5, 513, 100003, "
        "3000001} x reverse: OK")

    for nn, pp, cc in ((0, 4, 2), (1, 2, 1), (100, 8, 5), (600, 2, 400),
                       (257, 5, 1), (100003, 64, 900), (2000003, 64, 20000)):
        dd = r.ints(nn, 0, pp)
        for a, b in zip(bucket_route(dd, pp, cc, block=64),
                        bucket_route_ref(dd, pp, cc)):
            exact(a, b, f"bucket_route n={nn} p={pp} C={cc}")
    one = torch.zeros(90, dtype=torch.int32, device=r.dev)
    for a, b in zip(bucket_route(one, 4, 100, block=32),
                    bucket_route_ref(one, 4, 100)):
        exact(a, b, "bucket_route all rows to one destination")
    log("edge: bucket_route — ragged N, N=0, p {2, 4, 5, 8, 64}, C below "
        "demand, all rows to one destination: OK")


def kernel_checks(main_launches, reps: int):
    """Each kernel against its plain version at the main path's largest
    shape, then timed beside its bound, its plain version and the library
    call where one exists."""
    import torch

    from repro_torch.kernels.moe_route.ref import bucket_route_ref
    from repro_torch.kernels.moe_route.route import bucket_route_fwd
    from repro_torch.kernels.segment_reduce.ref import segment_scan_plain
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_reduce_fwd
    from repro_torch.kernels.ssd_scan.prefix import prefix_scan_fwd
    from repro_torch.kernels.ssd_scan.ref import prefix_scan_ref

    r = _Rand(0)

    def largest(name):
        return max(main_launches[name][2], key=lambda gm: gm[0][0])

    rows = []

    (n, d), op = largest("segment_reduce")
    v = r.ints(n, shape=(n, d))
    hb = r.rand(n) < 0.05
    hb[0] = True
    fwd, plain = segment_reduce_fwd, segment_scan_plain
    got, ref = fwd(v, hb, op=op, block=256), plain(v, hb, op)
    exact(got, ref, f"segment_reduce {n}x{d} {op}")
    nbytes = 2 * n * d * 4 + n  # values in, scan out, flags in
    rows.append(dict(
        name="segment_reduce", route="triton",
        source="src/repro_torch/kernels/segment_reduce/segment_reduce.py",
        replaces="src/repro/kernels/segment_reduce/segment_reduce.py:56",
        launches=main_launches["segment_reduce"][0], max_abs_err=max_err(got, ref),
        ms=time_ms(lambda: fwd(v, hb, op=op, block=256), reps),
        plain_ms=time_ms(lambda: plain(v, hb, op), max(reps // 4, 2)),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None, shape=[n, d], op=op))

    (n,), op = largest("prefix_scan")
    x = r.ints(n, 0, n)
    fwd, plain = prefix_scan_fwd, prefix_scan_ref
    got, ref = fwd(x, op=op, block=512), plain(x, op)
    exact(got, ref, f"prefix_scan {n} {op}")
    lib = {"min": lambda: torch.cummin(x, 0), "max": lambda: torch.cummax(x, 0),
           "sum": lambda: torch.cumsum(x, 0, dtype=x.dtype)}[op]
    rows.append(dict(
        name="prefix_scan", route="triton",
        source="src/repro_torch/kernels/ssd_scan/prefix.py",
        replaces="src/repro/kernels/ssd_scan/prefix.py:54",
        launches=main_launches["prefix_scan"][0], max_abs_err=max_err(got, ref),
        ms=time_ms(lambda: fwd(x, op=op, block=512), reps),
        plain_ms=time_ms(lambda: plain(x, op), max(reps // 4, 2)),
        bound_ms=2 * n * 4 / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=time_ms(lib, max(reps // 4, 2)), shape=[n], op=op))

    (n,), P, C = largest("bucket_route")
    dest = r.ints(n, 0, P)
    fwd, plain = bucket_route_fwd, bucket_route_ref
    got, ref = fwd(dest, P, C, block=128), plain(dest, P, C)
    for a, b, nm in zip(got, ref, ("pos", "keep", "counts")):
        exact(a, b, f"bucket_route {n} P={P} C={C} {nm}")
    rows.append(dict(
        name="bucket_route", route="triton",
        source="src/repro_torch/kernels/moe_route/route.py",
        replaces="src/repro/kernels/moe_route/route.py:50",
        launches=main_launches["bucket_route"][0],
        max_abs_err=max(max_err(a, b) for a, b in zip(got, ref)),
        ms=time_ms(lambda: fwd(dest, P, C, block=128), reps),
        plain_ms=time_ms(lambda: plain(dest, P, C), reps),
        bound_ms=(n * 4 + n * 4 + n + P * 4) / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=None, shape=[n], p=P, capacity=C))

    for row in rows:
        lib = row["library_ms"]
        log(f"kernel {row['name']}: shape {row['shape']} launches {row['launches']} "
            f"max_abs_err {row['max_abs_err']} | {row['ms']:.4f} ms vs bound "
            f"{row['bound_ms']:.4f} ms (bytes / 3.35 TB/s) | plain "
            f"{row['plain_ms']:.4f} ms | library "
            f"{'none' if lib is None else f'{lib:.4f} ms'}")
    return rows


def build():
    import torch

    from repro_torch.kernels import registry

    for name, probe in registry._PROBES.items():
        t0 = time.perf_counter()
        probe("cuda")
        torch.cuda.synchronize()
        log(f"build: {name} first launch (Triton compile) "
            f"{time.perf_counter() - t0:.2f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log2n", type=int, default=26, help="log2 of the word count")
    ap.add_argument("--p", type=int, default=8, help="virtual executor ranks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20, help="timed launches per kernel")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401 — fails outside a checkout of the repo

    t_all = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    try:
        build()
        edge_checks()
        launches = main_path(args)
        rows = kernel_checks(launches, args.reps)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(f"gpu: {smi[0] if smi else 'nvidia-smi gave nothing'}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
