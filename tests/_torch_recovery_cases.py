"""Recovery-tier scenarios run alike by the JAX package and the torch port,
for tests/test_torch_faults.py, tests/test_torch_elastic.py and
tests/test_torch_streaming.py.

Each case takes a ``Pkg`` (one package's modules behind one surface) and
returns a JSON-able record: collected rows in a framework-free form, and
every counter the reference's own tests assert on (scheduler retries, fault
injections, block restores and recomputes, ``reshard_*``, group reshards,
stream offsets and replays). The tests run the cases at p = 1 on both
packages in-process, and at p = 8 against the JAX records that
tests/_torch_recovery_main.py writes from a subprocess on 8 fake XLA host
devices. Row functions are written once for both frameworks (``x % 13``
means the same to a jax and a torch tensor).
"""
from __future__ import annotations

import os
import tempfile
import threading
import time

import numpy as np

VALS = np.random.default_rng(0).integers(0, 100_000, 2048).astype(np.int32)


# ---------------------------------------------------------------------------
# one surface over either package
# ---------------------------------------------------------------------------

class Pkg:
    """``name`` is ``"jax"`` or ``"torch"``; ``slots`` is how many devices
    (rank slots) a cluster may grow into: the JAX process's device count,
    which the port's cluster takes as an argument."""

    def __init__(self, name: str, slots: int):
        self.name = name
        self.slots = slots
        if name == "jax":
            import jax.numpy as jnp

            import repro.checkpoint as checkpoint
            import repro.core as core
            import repro.streaming as streaming
            from repro.core import comm, faults
            from repro.core.dag import DagEngine
            from repro.core.job import IJob, default_scheduler
            from repro.core.native import ignis_export
            from repro.core.partition import block_devices
            from repro.distributed import elastic

            self.base_props = {}
            self.put = jnp.asarray
            self._devs = block_devices
        else:
            import torch

            import repro_torch.checkpoint as checkpoint
            import repro_torch.core as core
            import repro_torch.streaming as streaming
            from repro_torch.core import comm, faults
            from repro_torch.core.dag import DagEngine
            from repro_torch.core.job import IJob, default_scheduler
            from repro_torch.core.native import ignis_export
            from repro_torch.core.partition import block_ranks
            from repro_torch.distributed import elastic

            self.base_props = {"ignis.device": "cpu"}
            self.put = torch.as_tensor
            self._devs = block_ranks
        self.core, self.comm, self.faults = core, comm, faults
        self.FaultPlan = faults.FaultPlan
        self.DagEngine, self.IJob = DagEngine, IJob
        self.scheduler = default_scheduler
        self.export = ignis_export
        self.checkpoint, self.elastic, self.streaming = checkpoint, elastic, streaming

    def worker(self, p: int = 1, **props):
        core = self.core
        P = core.IProperties({**self.base_props, "ignis.executor.instances": str(p),
                              **{k: str(v) for k, v in props.items()}})
        cluster = (core.ICluster(P) if self.name == "jax"
                   else core.ICluster(P, slots=max(self.slots, p)))
        return core.IWorker(cluster, "python")

    def devs(self, block):
        """The sorted ids of the devices (ranks) a block is committed to."""
        d = self._devs(block)
        if d is None:
            return None
        return sorted(getattr(x, "id", x) for x in d)

    def world(self, w):
        ctx = w.context
        if self.name == "jax":
            return [d.id for d in ctx.mesh.devices.flat]
        return list(ctx.ranks)

    def retries(self) -> int:
        return int(self.scheduler().stats["task_retries"])

    def sched(self, key) -> int:
        return int(self.scheduler().stats[key])


def norm(x):
    """A framework-free, order-free rendering of a collected row."""
    if isinstance(x, dict):
        return tuple((k, norm(v)) for k, v in sorted(x.items()))
    if isinstance(x, (tuple, list)):
        return tuple(norm(v) for v in x)
    a = np.asarray(x)
    return (str(a.dtype), a.tolist())


def rows(df) -> list:
    return sorted(repr(norm(r)) for r in df.collect())


def ints(df) -> list:
    return sorted(int(x) for x in df.collect())


def recovers(pkg, build, collect, plan, expect=1) -> dict:
    """No-fault oracle, then a fresh lineage under ``plan``: the rows, the
    scheduler retries and the injections, as the reference's
    ``_assert_recovers`` reads them."""
    oracle = collect(build())
    r0 = pkg.retries()
    with pkg.faults.inject(plan):
        got = collect(build())
    return {"rows": got, "same": got == oracle, "retries": pkg.retries() - r0,
            "injections": plan.injections(), "expect": expect}


def raises(fn, *types) -> str:
    """The name of the exception ``fn`` raised ('' when it returned)."""
    try:
        fn()
    except types as e:
        return type(e).__name__ if not isinstance(e, IOError) else "IOError"
    return ""


# ---------------------------------------------------------------------------
# faults: the chaos matrix of tests/test_faults.py and tests/_faults_main.py
# ---------------------------------------------------------------------------

def f_narrow(pkg, p, block):
    w = pkg.worker(p)
    return recovers(pkg, lambda: w.parallelize(VALS[:40 * p], blocks=4).map(lambda x: x * 2),
                    ints, pkg.FaultPlan().kill_block(op="map", block=block))


def f_fused(pkg, p, block):
    w = pkg.worker(p)

    def build():
        df = (w.parallelize(VALS[:40 * p], blocks=4).map(lambda x: x * 2)
              .filter(lambda x: x % 3 == 0).map(lambda x: x + 1))
        assert w.engine.plan(df.node), "chain must fuse"
        return df

    return recovers(pkg, build, ints, pkg.FaultPlan().kill_block(op="map", block=block))


WIDE = {
    "sort": lambda w, n: w.parallelize(VALS[:n]).sort(),
    "distinct": lambda w, n: w.parallelize(VALS[:n]).map(lambda x: x % 17).distinct(),
    "reduceByKey": lambda w, n: w.parallelize(VALS[:n])
    .map(lambda x: {"key": x % 13, "value": 1}).reduce_by_key(lambda a, b: a + b, 0),
    "groupByKey": lambda w, n: w.parallelize(VALS[:min(n, 256)])
    .map(lambda x: {"key": x % 7, "value": x}).group_by_key(),
    "partitionBy": lambda w, n: w.parallelize(VALS[:min(n, 512)])
    .map(lambda x: {"key": x % 5, "value": x}).partition_by(),
}


def f_wide(pkg, p, kind):
    w = pkg.worker(p)
    n = 30 if p == 1 else len(VALS)
    return recovers(pkg, lambda: WIDE[kind](w, n), rows, pkg.FaultPlan().fail_collective(kind))


def f_join(pkg, p):
    w = pkg.worker(p)
    nl, nr = (16, 8) if p == 1 else (256, 64)

    def build():
        l = w.parallelize(np.arange(nl, dtype=np.int32)).map(
            lambda x: {"key": x % 8, "value": x})
        r = w.parallelize(np.arange(nr, dtype=np.int32)).map(
            lambda x: {"key": x % 8, "value": x * 2})
        return l.join(r, max_matches=4 if p == 1 else 8)

    return recovers(pkg, build, rows, pkg.FaultPlan().fail_collective("join"))


def f_native(pkg, p):
    w = pkg.worker(p)
    runs = []

    @pkg.export("recovery_scale")
    def recovery_scale(ctx, data=None, valid=None):
        runs.append(1)
        return data * 3, valid

    rec = recovers(pkg, lambda: w.call("recovery_scale",
                                       w.parallelize(np.arange(12 * p, dtype=np.int32))),
                   ints, pkg.FaultPlan().fail_node(op="call:recovery_scale"))
    return {**rec, "app_runs": len(runs)}


def f_reshard(pkg, p):
    w1 = pkg.worker(p)
    w2 = pkg.core.IWorker(w1.cluster, "python", name="dst-w")
    return recovers(pkg, lambda: w2.import_data(
        w1.parallelize(np.arange(20 * p, dtype=np.int32)).map(lambda x: x + 1)),
        ints, pkg.FaultPlan().fail_reshard(kind="importData"))


def f_action(pkg, p):
    w = pkg.worker(p)
    return recovers(pkg, lambda: w.parallelize(VALS[:24 * p], blocks=2).map(lambda x: x + 3),
                    lambda df: df.count(), pkg.FaultPlan().fail_task(name="count(*"))


def f_take(pkg, p):
    w = pkg.worker(p)
    return recovers(pkg, lambda: w.parallelize(np.arange(40, dtype=np.int32), blocks=4)
                    .map(lambda x: x + 1), lambda df: [int(x) for x in df.take(5)],
                    pkg.FaultPlan().kill_block(op="map", block=0))


def f_budget_retry(pkg, p):
    w = pkg.worker(p, **{"ignis.task.attempts": 3})
    plan = (pkg.FaultPlan().kill_block(op="map", block=1, attempt=0)
            .kill_block(op="map", block=1, attempt=1))
    return recovers(pkg, lambda: w.parallelize(VALS[:16 * p], blocks=2).map(lambda x: x * 5),
                    ints, plan, expect=2)


def f_budget_exhaustion(pkg, p):
    w = pkg.worker(p)
    df = w.parallelize(np.arange(8, dtype=np.int32)).map(lambda x: x)
    plan = pkg.FaultPlan().fail("dag.block", op="map", block=0, attempt=None)
    r0 = pkg.retries()
    with pkg.faults.inject(plan):
        err = raises(df.collect, pkg.faults.FaultInjected)
    return {"raised": err, "retries": pkg.retries() - r0, "injections": plan.injections()}


def f_non_recoverable(pkg, p):
    w = pkg.worker(p)

    @pkg.export("recovery_boom")
    def recovery_boom(ctx, data=None, valid=None):
        raise ValueError("deterministic app bug")

    fut = w.call("recovery_boom", w.parallelize(np.arange(4, dtype=np.int32))).count_async()
    r0 = pkg.retries()
    err = raises(lambda: fut.result(30), ValueError)
    return {"raised": err, "retries": pkg.retries() - r0, "attempt": fut.task.attempt,
            "state": fut.task.state}


def f_retries_disabled(pkg, p):
    w = pkg.worker(p, **{"ignis.task.attempts": 1})
    df = w.parallelize(np.arange(8, dtype=np.int32)).map(lambda x: x)
    r0 = pkg.retries()
    with pkg.faults.inject(pkg.FaultPlan().kill_block(op="map", block=0)):
        err = raises(df.collect, pkg.faults.FaultInjected)
    return {"raised": err, "retries": pkg.retries() - r0}


def f_cascade(pkg, p):
    w = pkg.worker(p)
    job = pkg.IJob("cascade")
    df = w.parallelize(np.arange(8, dtype=np.int32)).map(lambda x: x)
    with pkg.faults.inject(pkg.FaultPlan().fail("job.task", name="count(*", attempt=None)):
        f1 = df.count_async(job=job)
        err = raises(lambda: f1.result(30), pkg.faults.FaultInjected)
    return {"raised": err}


def f_ckpt_truncates(pkg, p):
    w = pkg.worker(p)
    with tempfile.TemporaryDirectory() as td:
        ck = (w.parallelize(VALS[:40], blocks=4).map(lambda x: x + 1)
              .map(lambda x: x * 3).checkpoint(td))
        return {"parents": len(ck.node.parents), "op": ck.node.op.split("(")[0],
                "rows": ints(ck), "devs": pkg.devs(ck.node.result[0])}


def f_ckpt_repair(pkg, p):
    w = pkg.worker(p)
    with tempfile.TemporaryDirectory() as td:
        src = w.parallelize(VALS[:40 * p], blocks=4)
        ck = src.map(lambda x: x + 1).checkpoint(td)
        tail = ck.map(lambda x: x * 2)
        oracle = ints(tail)
        src_cc = src.node.compute_count
        base = dict(w.engine.stats)
        pkg.DagEngine.kill_block(ck.node, 2)
        got = ints(tail)
        return {"rows": got, "same": got == oracle,
                "restores": w.engine.stats["block_restores"] - base["block_restores"],
                "recomputes": w.engine.stats["block_recomputes"] - base["block_recomputes"],
                "src_rereads": src.node.compute_count - src_cc,
                "parents": len(ck.node.parents), "devs": pkg.devs(ck.node.result[2])}


def f_ckpt_full_loss(pkg, p):
    w = pkg.worker(p)
    with tempfile.TemporaryDirectory() as td:
        ck = w.parallelize(VALS[:24], blocks=3).map(lambda x: x * 7).checkpoint(td)
        oracle = ints(ck)
        ck.node.result = None  # total cache loss: reload every block from disk
        got = ints(ck)
        return {"rows": got, "same": got == oracle}


def f_ckpt_corrupt(pkg, p):
    w = pkg.worker(p)
    with tempfile.TemporaryDirectory() as td:
        ck = w.parallelize(VALS[:16], blocks=2).map(lambda x: x + 9).checkpoint(td)
        sdir = os.path.join(td, [d for d in os.listdir(td) if d.startswith("step_")][0])
        victim = sorted(f for f in os.listdir(sdir) if f.endswith(".npy"))[0]
        with open(os.path.join(sdir, victim), "r+b") as f:
            f.seek(90)
            f.write(b"\xde\xad")
        pkg.DagEngine.kill_block(ck.node, 0)
        return {"raised": raises(ck.collect, IOError)}


def f_ckpt_post_map_kill(pkg, p):
    w = pkg.worker(p)
    with tempfile.TemporaryDirectory() as td:
        src = w.parallelize(VALS[:32], blocks=4)
        ck = src.map(lambda x: x + 1).checkpoint(td)
        src_cc = src.node.compute_count
        rec = recovers(pkg, lambda: ck.map(lambda x: x - 1), ints,
                       pkg.FaultPlan().kill_block(op="map", block=1))
        return {**rec, "src_rereads": src.node.compute_count - src_cc}


def f_speculative(pkg, p):
    w = pkg.worker(p, **{"ignis.task.speculative": "true",
                         "ignis.task.speculative.timeout": 0.25 if p == 1 else 0.5})
    g = w.groups(1 if p == 1 else 2)[0]
    oracle = ints(w.parallelize(VALS[:16 * p], blocks=2).map(lambda x: x + 5))
    df = w.parallelize(VALS[:16 * p], blocks=2).map(lambda x: x + 5)
    plan = pkg.FaultPlan().delay_block(op="map", block=0, seconds=1.5)
    with pkg.faults.inject(plan):
        got = sorted(int(x) for x in df.collect_async(job=pkg.IJob("spec", group=g)).result(60))
    return {"same": got == oracle, "speculative": w.engine.stats["speculative_retries"],
            "injections": plan.injections()}


def f_speculative_fast_and_ungrouped(pkg, p):
    w = pkg.worker(p, **{"ignis.task.speculative": "true",
                         "ignis.task.speculative.timeout": 5.0})
    g = w.groups(1)[0]
    df = w.parallelize(VALS[:16], blocks=2).map(lambda x: x + 5)
    fast = len(df.collect_async(job=pkg.IJob("fast", group=g)).result(60))
    plan = pkg.FaultPlan().delay_block(op="map", block=0, seconds=0.3)
    with pkg.faults.inject(plan):
        slow = w.parallelize(VALS[:16], blocks=2).map(lambda x: x + 5).count()
    return {"fast": fast, "slow": slow, "speculative": w.engine.stats["speculative_retries"]}


def f_executor_kill(pkg, p):
    w = pkg.worker(p)
    df = w.parallelize(VALS[:24 * p], blocks=3 if p == 1 else 8).map(lambda x: x * 7).persist()
    oracle = ints(df)
    base = w.engine.stats["block_recomputes"]
    lost = w.kill_executor(1 if p == 1 else 5, blacklist=False)
    got = ints(df)
    return {"lost": lost, "same": got == oracle,
            "recomputes": w.engine.stats["block_recomputes"] - base}


def f_blacklist(pkg, p):
    w = pkg.worker(p)
    gs = w.groups(p)  # cached BEFORE the kill: must not bypass it
    r = p - 1
    w.kill_executor(r)
    out = {"group": raises(lambda: w.context.group([r]), ValueError),
           "groups": raises(lambda: w.groups(p), ValueError)}
    w.restore_executor(r)
    out["restored"] = w.context.group([r]).executors
    out["same_groups"] = w.groups(p) is gs
    return out


def f_unpersist(pkg, p):
    w = pkg.worker(p)
    df = w.parallelize(VALS[:20], blocks=2).map(lambda x: x + 1).persist()
    out = {"count": df.count(), "held": df.node.result is not None}
    cc = df.node.compute_count
    df.unpersist()
    out.update(dropped=df.node.result is None and not df.node.cached, again=df.count(),
               recomputed=df.node.compute_count > cc, recached=df.node.result is not None)
    mid = (w.parallelize(VALS[:20]).map(lambda x: x * 2)
           .filter(lambda x: x % 2 == 0).persist())
    tail = mid.map(lambda x: x + 1)
    tail.count()
    out["boundary"] = mid.node not in w.engine.plan(tail.node)
    mid.unpersist()
    out["refused"] = any(mid.node in s.nodes for s in w.engine.plan(tail.node).values())
    holes = w.parallelize(VALS[:30], blocks=3).map(lambda x: x - 1).persist()
    oracle = ints(holes)
    pkg.DagEngine.kill_block(holes.node, 1)
    holes.unpersist()
    out["holes_safe"] = ints(holes) == oracle
    df2 = w.parallelize(VALS[:12], blocks=2).map(lambda x: x + 2).persist()
    job = pkg.IJob("memo-scope")
    out["job_count"] = df2.count_async(job=job).result(30)
    df2.unpersist()
    cc = df2.node.compute_count
    job.release()
    out["after_release"] = df2.count()
    out["job_recomputed"] = df2.node.compute_count > cc
    return out


def f_handles(pkg, p):
    w = pkg.worker(p)
    rec = recovers(pkg, lambda: w.parallelize(VALS[:48]).map(lambda x: x + 1),
                   lambda df: df.count(),
                   pkg.FaultPlan().kill_handle(coll="action.count", attempt=0))

    @pkg.export("recovery_leaky")
    def recovery_leaky(ctx, data=None, valid=None):
        pkg.comm.iallreduce(ctx, pkg.comm.shard_rows(
            ctx, pkg.put(np.arange(4 * ctx.executors, dtype=np.float32))))
        return data, valid

    f0 = pkg.sched("coll_flushed")
    n = w.call("recovery_leaky", w.parallelize(VALS[:16])).count()
    flushed = pkg.sched("coll_flushed") - f0
    rec2 = recovers(pkg, lambda: w.call("recovery_leaky", w.parallelize(VALS[:16])),
                    lambda df: df.count(),
                    pkg.FaultPlan().kill_handle(coll="allreduce", phase="flush", attempt=0))
    with pkg.faults.inject(pkg.FaultPlan().fail("comm.handle", coll="action.count",
                                                attempt=None)):
        err = raises(w.parallelize(VALS[:8]).count, pkg.faults.FaultInjected)
    return {"pending": rec, "count": n, "flushed": flushed >= 1, "flush": rec2,
            "exhausted": err}


def _rbk(w, n=64):
    return lambda: (w.parallelize(np.arange(n, dtype=np.int32))
                    .map(lambda x: {"key": x % 7, "value": x})
                    .reduce_by_key(lambda a, b: a + b, 0))


def f_kernels(pkg, p):
    import warnings

    w = pkg.worker(p, **{"ignis.kernels": "interpret"})
    n = 64 if p == 1 else 128
    rec = recovers(pkg, _rbk(w, n), rows, pkg.FaultPlan().fail_kernel_stage("reduceByKey"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        hits = w.shuffle_stats()["kernel_hits"]
    off = pkg.worker(p, **{"ignis.kernels": "off"})
    plan_off = pkg.FaultPlan().fail_kernel_stage()
    with pkg.faults.inject(plan_off):
        n_off = len(_rbk(off, n)().collect())
    oracle = rows(_rbk(w, n)())
    f0 = w.metrics("kernels")["kernel_fallbacks"]
    r0 = pkg.retries()
    plan_cap = pkg.FaultPlan().fail_kernel_capability()
    with pkg.faults.inject(plan_cap):
        degraded = rows(_rbk(w, n)())
    cap = {"same": degraded == oracle, "fired": plan_cap.injections() >= 1,
           "retries": pkg.retries() - r0,
           "fallbacks": w.metrics("kernels")["kernel_fallbacks"] > f0}
    with pkg.faults.inject(pkg.FaultPlan().fail("kernel.stage", kind="reduceByKey",
                                                attempt=None)):
        err = raises(_rbk(w, n)().collect, pkg.faults.FaultInjected)
    return {"stage": rec, "hits": hits >= 1, "off_rows": n_off,
            "off_injections": plan_off.injections(), "capability": cap, "exhausted": err}


def _stream_run(pkg, w, tenant, limit=50, seed=13, **kw):
    S = pkg.streaming
    sc = S.StreamContext(w, S.TenantRequestSource(0, seed=seed, limit=limit),
                         tenant=tenant, init_state=np.zeros((2,), np.int64), **kw)
    return sc, sc.run()


def f_stream(pkg, p):
    w = pkg.worker(p, **{"ignis.stream.batch.rows": 8})
    _, oracle = _stream_run(pkg, w, "oracle")
    out = {"oracle": oracle.tolist()}
    r0 = pkg.retries()
    plan = pkg.FaultPlan().fail_stream_batch(tenant="a", batch=3)
    with pkg.faults.inject(plan):
        sc, state = _stream_run(pkg, w, "a")
    out["kill"] = {"same": bool((state == oracle).all()), "retries": pkg.retries() - r0,
                   "injections": plan.injections("stream.batch"),
                   "replayed": sc.batches_replayed,
                   "job_replayed": sc.job.stats()["stream"]["tenants"]["a"]["batches_replayed"]}
    r0 = pkg.retries()
    plan = pkg.FaultPlan().fail_stream_batch(tenant="b", batch=2, attempt=None)
    with pkg.faults.inject(plan):
        err = raises(lambda: _stream_run(pkg, w, "b"), pkg.faults.FaultInjected)
    out["exhausted"] = {"raised": err, "retries": pkg.retries() - r0,
                        "injections": plan.injections("stream.batch")}
    r0 = pkg.retries()
    plan = pkg.FaultPlan().fail_stream_admit(tenant="c", times=2)
    with pkg.faults.inject(plan):
        sc, _ = _stream_run(pkg, w, "c")
    snap = sc.job.stats()["stream"]["tenants"]["c"]
    out["admit"] = {"shed": sc.shed_batches, "committed": sc.committed, "offset": sc.offset,
                    "retries": pkg.retries() - r0,
                    "injections": plan.injections("stream.admit"),
                    "snap": [snap["shed"], snap["completed"]]}
    w.cluster.props["ignis.stream.checkpoint.interval"] = "2"
    with tempfile.TemporaryDirectory() as td:
        d = os.path.join(td, "ck")
        r0 = pkg.retries()
        plan = pkg.FaultPlan().fail_stream_batch(tenant="d", batch=5, attempt=None)
        with pkg.faults.inject(plan):
            err = raises(lambda: _stream_run(pkg, w, "d", ckpt_dir=d),
                         pkg.faults.FaultInjected)
        retries, inj = pkg.retries() - r0, plan.injections("stream.batch")
        sc2, state = _stream_run(pkg, w, "d", ckpt_dir=d)
        out["restart"] = {"raised": err, "retries": retries, "injections": inj,
                          "restored_in_range": sc2.restored_from is not None
                          and 2 <= sc2.restored_from <= 5,
                          "same": bool((state == oracle).all()), "offset": sc2.offset,
                          "committed": sc2.committed, "replayed": sc2.batches_replayed}
    return out


# -- p = 8 only (tests/_faults_main.py) --------------------------------------

def f_overflow(pkg, p):
    import warnings

    w = pkg.worker(p, **{"ignis.shuffle.capacity.factor": 0.05})
    vals = np.random.default_rng(1).integers(0, 1000, 1024).astype(np.int32)
    plan = pkg.FaultPlan().fail("shuffle.overflow", kind="capacity")
    r0 = pkg.retries()
    with pkg.faults.inject(plan):
        got = [int(x) for x in w.parallelize(vals).sort().collect()]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ovf = w.shuffle_stats()["overflow_retries"]
    return {"same": got == sorted(int(v) for v in vals), "retries": pkg.retries() - r0,
            "injections": plan.injections(), "overflow_retries": ovf}


def f_group_edge(pkg, p):
    w = pkg.worker(p)
    g0, g1 = w.groups(2)
    widths = []

    @pkg.export("recovery_ident")
    def recovery_ident(ctx, data=None, valid=None):
        widths.append(int(ctx.executors))
        return data, valid

    def build():
        job = pkg.IJob("edge", scheduler=pkg.scheduler())
        shared = w.call("recovery_ident", w.parallelize(np.arange(64, dtype=np.int32)))
        return (shared.count_async(job=job, group=g0),
                shared.map(lambda x: x + 1).collect_async(job=job, group=g1))

    f1, f2 = build()
    oracle = (f1.result(120), sorted(int(x) for x in f2.result(120)))
    r0, m0 = pkg.retries(), pkg.sched("group_reshards")
    plan = pkg.FaultPlan().fail_reshard(kind="group")
    with pkg.faults.inject(plan):
        f1, f2 = build()
        got = (f1.result(120), sorted(int(x) for x in f2.result(120)))
    return {"same": got == oracle, "retries": pkg.retries() - r0,
            "injections": plan.injections(), "moved": pkg.sched("group_reshards") - m0,
            "widths": sorted(set(widths))}


def f_elastic_reshard_fault(pkg, p):
    w = pkg.worker(4)
    vals = VALS[:1024]
    df = w.parallelize(vals, blocks=4).map(lambda x: x * 5).persist()
    oracle = ints(df)
    base = w.engine.stats["block_recomputes"]
    r0 = pkg.retries()
    plan = pkg.FaultPlan().fail_elastic_reshard(op="map", block=2)
    with pkg.faults.inject(plan):
        w.grow(2)
    st = dict(w.metrics("elastic"))
    hole = df.node.result[2] is None
    got = ints(df)
    return {"injections": plan.injections("elastic.reshard"), "elastic": st, "hole": hole,
            "same": got == oracle,
            "recomputes": w.engine.stats["block_recomputes"] - base,
            "retries": pkg.retries() - r0}


def f_shrink_mid_gang(pkg, p):
    w = pkg.worker(8)
    g0, _g1 = w.groups(2)
    vals = VALS[:1024]
    oracle = ints(w.parallelize(vals, blocks=2).map(lambda x: x + 9))
    df = w.parallelize(vals, blocks=2).map(lambda x: x + 9)
    r0 = pkg.retries()
    with pkg.faults.inject(pkg.FaultPlan().delay_block(op="map", block=0, seconds=1.5)):
        fut = df.collect_async(job=pkg.IJob("gang-shrink", group=g0))
        time.sleep(0.3)  # let the straggler take the group lock
        t0 = time.monotonic()
        w.shrink(2)  # drains the in-flight gang task first
        drained = time.monotonic() - t0
        got = sorted(int(x) for x in fut.result(120))
    return {"same": got == oracle, "world": w.executors, "drained": drained >= 0.5,
            "retries": pkg.retries() - r0}


def f_stream_groups(pkg, p):
    S = pkg.streaming
    w = pkg.worker(8, **{"ignis.stream.batch.rows": 16})

    def fe_run(tag):
        fe = S.TenantFrontEnd(w, n_groups=4, name=f"stream-{tag}")
        for i in range(4):
            fe.admit(f"t{i}", S.TenantRequestSource(i, seed=31, limit=96),
                     init_state=np.zeros((2,), np.int64))
        return fe, fe.run()

    _, oracle = fe_run("oracle")
    r0 = pkg.retries()
    plan = pkg.FaultPlan().fail_stream_batch(tenant="t2", batch=3)
    with pkg.faults.inject(plan):
        fe, got = fe_run("chaos")
    out = {"states": {t: v.tolist() for t, v in sorted(got.items())},
           "same": all(bool((got[t] == oracle[t]).all()) for t in oracle),
           "retries": pkg.retries() - r0, "injections": plan.injections("stream.batch"),
           "replayed": fe.stream("t2").batches_replayed,
           "job_replayed": fe.job.stats()["stream"]["batches_replayed"]}
    w.cluster.props["ignis.stream.checkpoint.interval"] = "2"
    grp = w.groups(4)[1]
    with tempfile.TemporaryDirectory() as td:
        def ck_stream(tenant, ckpt=True):
            return S.StreamContext(w, S.TenantRequestSource(5, seed=31, limit=96),
                                   tenant=tenant, group=grp,
                                   init_state=np.zeros((2,), np.int64),
                                   ckpt_dir=td if ckpt else None)

        ck_oracle = ck_stream("ck-oracle", ckpt=False).run()
        r0 = pkg.retries()
        plan = pkg.FaultPlan().fail_stream_batch(tenant="ck", batch=4, attempt=None)
        with pkg.faults.inject(plan):
            died = raises(ck_stream("ck").run, pkg.faults.FaultInjected)
        sc2 = ck_stream("ck")
        st2 = sc2.run()
        out["restart"] = {"died": died, "restored_from": sc2.restored_from,
                          "same": bool((st2 == ck_oracle).all()),
                          "committed": sc2.committed, "offset": sc2.offset,
                          "retries": pkg.retries() - r0,
                          "injections": plan.injections("stream.batch"),
                          "replayed": sc2.batches_replayed}
    return out


def f_resize_mid_pump(pkg, p):
    S = pkg.streaming
    w = pkg.worker(6, **{"ignis.stream.batch.rows": 16})

    def pump_run(tag, resize=False, plan=None):
        fe = S.TenantFrontEnd(w, n_groups=2, name=f"elastic-{tag}")
        for i in range(2):
            fe.admit(f"e{i}", S.TenantRequestSource(i, seed=13, limit=96),
                     init_state=np.zeros((2,), np.int64))
        sizes = []
        th = None
        if resize:
            def resizer():
                while fe.job.metrics("stream")["completed"] < 3:
                    time.sleep(0.005)
                sizes.append(w.grow(2))
                while fe.job.metrics("stream")["completed"] < 7:
                    time.sleep(0.005)
                sizes.append(w.shrink(2))
            th = threading.Thread(target=resizer, daemon=True)
            th.start()
        if plan is not None:
            with pkg.faults.inject(plan):
                out = fe.run()
        else:
            out = fe.run()
        if th is not None:
            th.join(60)
        return fe, out, sizes

    _, oracle, _ = pump_run("oracle")
    r0 = pkg.retries()
    plan = pkg.FaultPlan().fail_stream_batch(tenant="e1", batch=2)
    fe, got, sizes = pump_run("chaos", resize=True, plan=plan)
    return {"same": all(bool((got[t] == oracle[t]).all()) for t in oracle),
            "sizes": sizes, "world": w.executors, "retries": pkg.retries() - r0,
            "injections": plan.injections("stream.batch"),
            "replayed": fe.stream("e1").batches_replayed,
            "reshard_recomputes": w.metrics("elastic")["reshard_recomputes"]}


FAULTS = {
    **{f"narrow_block{b}": (lambda pkg, p, _b=b: f_narrow(pkg, p, _b)) for b in range(4)},
    **{f"fused_block{b}": (lambda pkg, p, _b=b: f_fused(pkg, p, _b)) for b in range(4)},
    **{f"wide_{k}": (lambda pkg, p, _k=k: f_wide(pkg, p, _k)) for k in WIDE},
    "wide_join": f_join,
    "native": f_native,
    "reshard": f_reshard,
    "action": f_action,
    "take_iter": f_take,
    "budget_retry": f_budget_retry,
    "budget_exhaustion": f_budget_exhaustion,
    "non_recoverable": f_non_recoverable,
    "retries_disabled": f_retries_disabled,
    "cascade": f_cascade,
    "ckpt_truncates": f_ckpt_truncates,
    "ckpt_repair": f_ckpt_repair,
    "ckpt_full_loss": f_ckpt_full_loss,
    "ckpt_corrupt": f_ckpt_corrupt,
    "ckpt_post_map_kill": f_ckpt_post_map_kill,
    "speculative": f_speculative,
    "speculative_fast_and_ungrouped": f_speculative_fast_and_ungrouped,
    "executor_kill": f_executor_kill,
    "blacklist": f_blacklist,
    "unpersist": f_unpersist,
    "handles": f_handles,
    "kernels": f_kernels,
    "stream": f_stream,
}
#: cases that need a world of several devices: p = 8 only
FAULTS_P8 = {
    "overflow": f_overflow,
    "group_edge": f_group_edge,
    "elastic_reshard_fault": f_elastic_reshard_fault,
    "shrink_mid_gang": f_shrink_mid_gang,
    "stream_groups": f_stream_groups,
    "resize_mid_pump": f_resize_mid_pump,
}


# ---------------------------------------------------------------------------
# elastic: tests/_elastic_main.py's conformance tier and the group reshards
# ---------------------------------------------------------------------------

def e_group_reshards(pkg, p, case):
    """A frame consumed by a reduceByKey on a group: ``world`` — a frame
    persisted on the world; ``other`` — persisted on group 1, consumed on
    group 0; ``own`` — persisted and consumed on group 0. Through the
    eager path (the shuffle's ingress counts) and through an IJob pinned
    to the group behind a native producer (the scheduler's overlay
    counts)."""
    import warnings

    w = pkg.worker(p)
    gs = w.groups(2)

    @pkg.export("recovery_pass")
    def recovery_pass(ctx, data=None, valid=None):
        return data, valid

    home = {"world": None, "other": gs[1], "own": gs[0]}[case]
    with w.use_group(home):
        df = w.parallelize(VALS[:512]).map(lambda x: {"key": x % 13, "value": x}).persist()
        df.count()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        s0 = w.shuffle_stats()["group_reshards"]
        with w.use_group(gs[0]):
            got = rows(df.reduce_by_key(lambda a, b: a + b, 0))
        s1 = w.shuffle_stats()["group_reshards"]
        # one job: the native producer runs on the frame's home communicator,
        # then its consumer on group 0 reads it through the reshard edge
        job = pkg.IJob(f"gr-{case}")
        src = w.call("recovery_pass", df)
        src.count_async(job=job, group=home).result(60)
        m0 = pkg.sched("group_reshards")
        s1 = w.shuffle_stats()["group_reshards"]
        f = src.reduce_by_key(lambda a, b: a + b, 0).collect_async(job=job, group=gs[0])
        got2 = sorted(repr(norm(r)) for r in f.result(60))
        s2 = w.shuffle_stats()["group_reshards"]
    return {"rows": got, "job_rows_same": got2 == got, "shuffle": s1 - s0,
            "shuffle_job": s2 - s1, "scheduler": pkg.sched("group_reshards") - m0,
            "devs": pkg.devs(df.node.result[0])}


def _build_frames(w, vals):
    fr = {"src": w.parallelize(vals),
          "kv_l": w.parallelize(np.arange(256, dtype=np.int32)),
          "kv_r": w.parallelize(np.arange(64, dtype=np.int32))}
    fr["mapped"] = fr["src"].map(lambda x: x * 3 ^ 5).persist()
    fr["mapped"].count()
    return fr


def _matrix(pkg, w, fr):
    out = {}
    out["narrow"] = rows(fr["src"].map(lambda x: x + 9))
    out["fused"] = rows(fr["src"].map(lambda x: x * 2).map(lambda x: x - 3)
                        .filter(lambda x: x % 3 == 0))
    out["wide_sort"] = [int(x) for x in fr["mapped"].sort().collect()]
    out["wide_distinct"] = rows(fr["src"].map(lambda x: x % 17).distinct())
    out["wide_reduceByKey"] = rows(fr["src"].map(lambda x: {"key": x % 13, "value": 1})
                                   .reduce_by_key(lambda a, b: a + b, 0))
    gk = fr["kv_l"].map(lambda x: {"key": x % 7, "value": x}).group_by_key(group_capacity=64)
    out["wide_groupByKey"] = sorted(
        (int(np.asarray(r["key"])),
         tuple(sorted(int(v) for v, m in zip(np.asarray(r["value"]["items"]),
                                              np.asarray(r["value"]["mask"])) if m)))
        for r in gk.collect())
    out["wide_partitionBy"] = sorted(
        int(np.asarray(r["value"])) for r in
        fr["kv_l"].map(lambda x: {"key": x % 5, "value": x}).partition_by().collect())
    out["wide_join"] = rows(fr["kv_l"].map(lambda x: {"key": x % 8, "value": x})
                            .join(fr["kv_r"].map(lambda x: {"key": x % 8, "value": x * 2})))

    @pkg.export("recovery_native_scale")
    def recovery_native_scale(ctx, data, valid):
        return data * 2, valid

    out["native"] = [int(x) for x in w.call("recovery_native_scale", fr["mapped"]).collect()]
    out["action_count"] = fr["mapped"].count()
    out["action_take"] = [int(x) for x in fr["src"].take(5)]
    return out


def e_conformance(pkg, p):
    w = pkg.worker(4)
    vals = np.random.default_rng(0).integers(0, 100000, 4096).astype(np.int32)
    fr = _build_frames(w, vals)
    with w.use_group(w.groups(2)[0]):
        gframe = w.parallelize(np.arange(128, dtype=np.int32))
        g_oracle = rows(gframe.map(lambda x: x * 7))
    gs4 = w.groups(2)
    out = {"g_devs0": pkg.devs(gframe.node.result[0])}
    oracle = _matrix(pkg, w, fr)
    out["oracle"] = oracle
    eng0 = w.metrics("stages")["block_recomputes"]
    cc = fr["mapped"].node.compute_count
    out["grow"] = w.grow(2)
    out["after_grow"] = dict(w.metrics("elastic"))
    out["g_devs_grow"] = pkg.devs(gframe.node.result[0])
    post = _matrix(pkg, w, fr)
    out["grow_same"] = {k: post[k] == oracle[k] for k in oracle}
    out["grow_recomputes"] = [w.metrics("stages")["block_recomputes"] - eng0,
                              fr["mapped"].node.compute_count - cc]
    src6 = w.parallelize(vals[:512])
    out["src6_devs"] = pkg.devs(src6.node.result[0])
    out["world6"] = pkg.world(w)
    gs6 = w.groups(2)
    out["groups6"] = [list(g.group_ranks) for g in gs6]
    out["groups_rebuilt"] = gs6[0] is not gs4[0]
    out["shrink"] = w.shrink(2)
    out["after_shrink"] = dict(w.metrics("elastic"))
    post = _matrix(pkg, w, fr)
    out["shrink_same"] = {k: post[k] == oracle[k] for k in oracle}
    out["shrink_recomputes"] = w.metrics("stages")["block_recomputes"] - eng0
    with w.use_group(w.groups(2)[0]):
        out["gframe_same"] = rows(gframe.map(lambda x: x * 7)) == g_oracle
    # a live job spans grow(2) then shrink(2)
    job = pkg.IJob("elastic-live")
    f1 = fr["mapped"].count_async(job=job)
    g = w.grow(2)
    f2 = fr["mapped"].count_async(job=job)
    f3 = fr["mapped"].sort().count_async(job=job)
    s = w.shrink(2)
    f4 = fr["mapped"].count_async(job=job)
    out["live"] = [g, s, f1.result(), f2.result(), f3.result(), f4.result(),
                   job.metrics("tasks")["failed"]]
    # capacity memory keyed per communicator size
    fr["mapped"].sort().count()
    sh0 = dict(w.metrics("shuffle"))
    fr["mapped"].sort().count()
    sh1 = dict(w.metrics("shuffle"))
    w.grow(1)
    fr["mapped"].sort().count()
    sh2 = dict(w.metrics("shuffle"))
    fr["mapped"].sort().count()
    sh3 = dict(w.metrics("shuffle"))
    keys = ("capacity_memory_hits", "capacity_memory_misses", "overflow_retries")
    out["capacity"] = [[sh[k] - sh0[k] for k in keys] for sh in (sh1, sh2, sh3)]
    w.shrink(1)
    # ElasticPolicy on the live worker
    for k, v in (("enabled", "true"), ("step", "2"), ("cooldown.polls", "2"),
                 ("queue.per.executor", "4")):
        w.cluster.props[f"ignis.elastic.{k}"] = v
    pol = pkg.elastic.ElasticPolicy(w)
    out["policy"] = [pol.poll(queue_depth=32), pol.poll(queue_depth=32), w.executors,
                     pol.poll(queue_depth=0), pol.poll(queue_depth=0), w.executors,
                     fr["mapped"].sort().count(), dict(pol.stats)]
    out["final"] = dict(w.metrics("elastic"))
    return out


NARROW_OPS = [
    (lambda df: df.map(lambda x: x * 3), lambda a: a * 3),
    (lambda df: df.map(lambda x: x + 11), lambda a: a + 11),
    (lambda df: df.map(lambda x: x ^ 0x55), lambda a: a ^ 0x55),
    (lambda df: df.filter(lambda x: x % 2 == 0), lambda a: a[a % 2 == 0]),
]


def e_join_leave(pkg, p, seed):
    w = pkg.worker(4)
    base = np.random.default_rng(100 + seed).integers(0, 5000, 1536).astype(np.int32)
    src = w.parallelize(base)
    r = np.random.default_rng(seed)
    ok, sizes = True, []
    for _step in range(6):
        frame, arr = src, base.copy()
        for _ in range(int(r.integers(1, 5))):
            k = int(r.integers(0, len(NARROW_OPS)))
            frame = NARROW_OPS[k][0](frame)
            arr = NARROW_OPS[k][1](arr)
        if r.integers(0, 2):
            ok = ok and [int(x) for x in frame.sort().collect()] == sorted(int(v) for v in arr)
        else:
            ok = ok and frame.count() == len(arr)
        q = w.executors
        if q <= 2:
            w.grow(int(r.integers(1, 3)))
        elif q >= 7:
            w.shrink(int(r.integers(1, 3)))
        elif r.integers(0, 2):
            w.grow(int(r.integers(1, min(3, 8 - q + 1))))
        else:
            w.shrink(int(r.integers(1, min(3, q))))
        sizes.append(w.executors)
    return {"ok": ok, "sizes": sizes, "elastic": dict(w.metrics("elastic")),
            "recomputes": w.metrics("stages")["block_recomputes"], "world": pkg.world(w)}


def e_shrink_ranks(pkg, p):
    """``shrink([1, 3])`` retires those positions; a blacklisted rank is
    re-keyed by identity; a grow appends free slots after the survivors."""
    w = pkg.worker(8)
    df = w.parallelize(VALS[:800], blocks=4).map(lambda x: x + 1).persist()
    oracle = ints(df)
    w.kill_executor(5, blacklist=True)
    w.restore_executor(5)
    w.kill_executor(6, blacklist=True)
    out = {"shrink": w.shrink([1, 3]), "world": pkg.world(w),
           "blacklist": sorted(w.executor_blacklist)}
    w.restore_executor(sorted(w.executor_blacklist)[0])
    out["grow"] = w.grow(1)
    out["world2"] = pkg.world(w)
    out["same"] = ints(df) == oracle
    out["elastic"] = dict(w.metrics("elastic"))
    out["stages"] = [w.metrics("stages")[k] for k in ("block_recomputes", "block_restores")]
    return out


ELASTIC_P8 = {
    **{f"group_reshards_{c}": (lambda pkg, p, _c=c: e_group_reshards(pkg, p, _c))
       for c in ("world", "other", "own")},
    "conformance": e_conformance,
    **{f"join_leave_seed{s}": (lambda pkg, p, _s=s: e_join_leave(pkg, p, _s))
       for s in (0, 1, 2)},
    "shrink_ranks": e_shrink_ranks,
}


# ---------------------------------------------------------------------------
# streaming: tests/test_streaming.py's cases at p = 1 and on gang groups
# ---------------------------------------------------------------------------

def _zeros():
    return np.zeros((2,), np.int64)


def s_exhaustion(pkg, p):
    S = pkg.streaming
    w = pkg.worker(p, **{"ignis.stream.batch.rows": 8})
    sc = S.StreamContext(w, S.TenantRequestSource(0, seed=1, limit=50), tenant="a",
                         init_state=_zeros())
    state = sc.run()
    snap = sc.job.stats()["stream"]
    t = snap["tenants"]["a"]
    return {"state": state.tolist(), "stats": sc.stats(),
            "snap": [t["completed"], snap["inflight"], t["admitted"], t["shed"]],
            "latency_order": t["latency_p99_ms"] >= t["latency_p50_ms"] > 0}


def s_backpressure(pkg, p):
    S = pkg.streaming
    w = pkg.worker(p, **{"ignis.stream.batch.rows": 8, "ignis.stream.max.inflight": 2})
    peak, waits = [0], [0]

    class Probe(S.AdmissionController):
        def try_admit(self, tenant):
            d = super().try_admit(tenant)
            with self._cond:
                peak[0] = max(peak[0], sum(self._inflight.values()))
            waits[0] += d == "wait"
            return d

    def slow_batch(rows_):
        time.sleep(0.005)
        return rows_.astype(np.int64).sum(axis=0)

    sc = S.StreamContext(w, S.TenantRequestSource(0, seed=2, limit=80), tenant="a",
                         init_state=_zeros(), admission=Probe(w.cluster.props),
                         batch_fn=slow_batch)
    state = sc.run()
    return {"state": state.tolist(), "committed": sc.committed, "bounded": peak[0] <= 2,
            "engaged": waits[0] >= 1}


def s_in_order(pkg, p):
    S = pkg.streaming
    w = pkg.worker(p, **{"ignis.stream.batch.rows": 8})
    folded = []

    def fold(state, result):
        folded.append(int(result[0]))
        return state + result

    sc = S.StreamContext(w, S.TenantRequestSource(0, seed=3, limit=64), tenant="a",
                         init_state=_zeros(),
                         batch_fn=lambda r: r.astype(np.int64).sum(axis=0), fold_fn=fold)
    sc.run()
    return {"folded": folded}


def s_isolation(pkg, p):
    S = pkg.streaming
    w = pkg.worker(p, **{"ignis.stream.batch.rows": 8})
    n_groups = 1 if p == 1 else 4
    fe = S.TenantFrontEnd(w, n_groups=n_groups)
    for i in range(3):
        fe.admit(f"t{i}", S.TenantRequestSource(i, seed=7, limit=40), init_state=_zeros())
    res = fe.run()
    solo = [S.StreamContext(w, S.TenantRequestSource(i, seed=7, limit=40),
                            tenant=f"solo{i}", init_state=_zeros()).run() for i in range(3)]
    snap = fe.telemetry.snapshot(fe.admission)
    return {"states": [res[f"t{i}"].tolist() for i in range(3)],
            "same": all(bool((res[f"t{i}"] == solo[i]).all()) for i in range(3)),
            "snap": [snap["completed"], snap["shed"], snap["inflight"]],
            "summary": "3 tenants" in fe.summary(),
            "job": fe.job.stats()["stream"]["completed"],
            "double": raises(lambda: fe.admit("t0", S.TenantRequestSource(0, limit=8),
                                              init_state=_zeros()), ValueError)}


def s_checkpoint_restart(pkg, p):
    S = pkg.streaming
    w = pkg.worker(p, **{"ignis.stream.batch.rows": 8})
    oracle = S.StreamContext(w, S.TenantRequestSource(0, seed=5, limit=48), tenant="o",
                             init_state=_zeros()).run()
    w.cluster.props["ignis.stream.checkpoint.interval"] = "2"
    with tempfile.TemporaryDirectory() as td:
        d = os.path.join(td, "ck")
        sc1 = S.StreamContext(w, S.TenantRequestSource(0, seed=5, limit=48), tenant="a",
                              init_state=_zeros(), ckpt_dir=d)
        sc1.run(max_batches=3)
        sc2 = S.StreamContext(w, S.TenantRequestSource(0, seed=5, limit=48), tenant="a",
                              init_state=_zeros(), ckpt_dir=d)
        restored = [sc2.restored_from, sc2.committed, sc2.offset]
        state = sc2.run()
        # the interval cuts depend on how far the pump ran ahead; the last
        # is the final drain's, at the stream's end
        last = pkg.checkpoint.latest_step(d)
    return {"first": [sc1.committed, sc1.offset], "restored": restored,
            "same": bool((state == oracle).all()), "offset": sc2.offset,
            "state": state.tolist(), "last_step": last,
            "needs_init": raises(lambda: S.StreamContext(
                w, S.TenantRequestSource(0, limit=8), ckpt_dir=d), ValueError)}


def s_skips_nothing(pkg, p):
    S = pkg.streaming
    w = pkg.worker(p, **{"ignis.stream.batch.rows": 8,
                         "ignis.stream.checkpoint.interval": 3})
    seen: list = []
    lock = threading.Lock()

    def spy(rows_):
        with lock:
            seen.extend(int(r) for r in rows_[:, 0])
        return rows_.astype(np.int64).sum(axis=0)

    with tempfile.TemporaryDirectory() as td:
        d = os.path.join(td, "ck")
        sc1 = S.StreamContext(w, S.TenantRequestSource(0, seed=9, limit=64), tenant="a",
                              init_state=_zeros(), ckpt_dir=d, batch_fn=spy)
        sc1.run(max_batches=3)
        first = sorted(seen)
        seen.clear()
        sc2 = S.StreamContext(w, S.TenantRequestSource(0, seed=9, limit=64), tenant="a",
                              init_state=_zeros(), ckpt_dir=d, batch_fn=spy)
        state = sc2.run()
    return {"union": first + sorted(seen) == list(range(64)), "first": first,
            "state": state.tolist(), "restored_from": sc2.restored_from}


def s_shed_policy(pkg, p):
    """Policy ``shed`` with one slot: batches beyond the bound are dropped
    and counted, the offset still reaches the end."""
    S = pkg.streaming
    w = pkg.worker(p, **{"ignis.stream.batch.rows": 8, "ignis.stream.max.inflight": 1,
                         "ignis.stream.tenant.quota": 1, "ignis.stream.shed.policy": "shed"})
    adm = S.AdmissionController(w.cluster.props)
    sc = S.StreamContext(w, S.TenantRequestSource(0, seed=4, limit=64), tenant="a",
                         init_state=_zeros(), admission=adm)
    sc.run()
    snap = sc.job.stats()["stream"]["tenants"]["a"]
    return {"policy": adm.policy, "offset": sc.offset,
            "accounted": sc.committed + sc.shed_batches == 8,
            "snap_matches": [snap["shed"], snap["completed"]] == [sc.shed_batches, sc.committed]}


def s_elastic_front_end(pkg, p):
    """``TenantFrontEnd(elastic=ElasticPolicy)``: every admission grows the
    world to one executor per tenant, up to ``max.executors``."""
    S = pkg.streaming
    w = pkg.worker(2, **{"ignis.stream.batch.rows": 16, "ignis.elastic.enabled": "true",
                         "ignis.elastic.max.executors": 6})
    df = w.parallelize(VALS[:600]).map(lambda x: x % 101).persist()
    oracle = ints(df)
    pol = pkg.elastic.ElasticPolicy(w)
    fe = S.TenantFrontEnd(w, n_groups=2, elastic=pol)
    sizes = []
    for i in range(5):
        fe.admit(f"t{i}", S.TenantRequestSource(i, seed=3, limit=64), init_state=_zeros())
        sizes.append(w.executors)
    res = fe.run()
    return {"sizes": sizes, "stats": dict(pol.stats), "elastic": dict(w.metrics("elastic")),
            "states": [res[f"t{i}"].tolist() for i in range(5)], "same": ints(df) == oracle}


STREAM = {
    "exhaustion": s_exhaustion,
    "backpressure": s_backpressure,
    "in_order": s_in_order,
    "isolation": s_isolation,
    "checkpoint_restart": s_checkpoint_restart,
    "skips_nothing": s_skips_nothing,
    "shed_policy": s_shed_policy,
}
STREAM_P8 = {"elastic_front_end": s_elastic_front_end}

#: every case group, by the name tests/_torch_recovery_main.py takes
GROUPS = {
    "faults": {**FAULTS, **FAULTS_P8},
    "elastic": ELASTIC_P8,
    "streaming": {**STREAM, **STREAM_P8},
}


def run_group(pkg, group: str, p: int) -> dict:
    """Every case of ``group`` at ``p``; a case that raises records the
    error, so one fault does not hide the others."""
    out = {}
    for name, fn in GROUPS[group].items():
        try:
            out[name] = fn(pkg, p)
        except Exception as e:  # recorded, and compared like any result
            out[name] = {"error": f"{type(e).__name__}: {e}"}
    return out


# ---------------------------------------------------------------------------
# what the tests hold every record to, and the p = 8 reference subprocess
# ---------------------------------------------------------------------------

def held(rec, path="") -> list:
    """What a record breaks of the reference tests' own assertions: an
    error, a result that differs from its no-fault oracle (``same``), or
    retries other than the plan asked for (``expect``)."""
    bad = []
    if isinstance(rec, dict):
        if "error" in rec:
            bad.append(f"{path}: {rec['error']}")
        if rec.get("same") is False:
            bad.append(f"{path}: differs from its oracle")
        if "expect" in rec and rec.get("retries") != rec["expect"]:
            bad.append(f"{path}: {rec.get('retries')} retries, expected {rec['expect']}")
        if "injections" in rec and "expect" in rec and rec["injections"] != rec["expect"]:
            bad.append(f"{path}: {rec['injections']} injections, expected {rec['expect']}")
        for k, v in rec.items():
            bad += held(v, f"{path}/{k}")
    return bad


def start_reference(group: str, out_path: str):
    """Start tests/_torch_recovery_main.py for ``group`` in a subprocess;
    returns a function that waits for it and gives its records."""
    import json
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(here, "..", "src"), env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(here, "_torch_recovery_main.py"), group,
         str(out_path)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    cell: dict = {}

    def result() -> dict:
        if "data" not in cell:
            so, se = proc.communicate(timeout=600)
            assert proc.returncode == 0, f"stdout:\n{so}\nstderr:\n{se[-3000:]}"
            assert "TORCH_RECOVERY_JAX_OK" in so
            with open(out_path) as f:
                cell["data"] = json.load(f)
        return cell["data"]

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()

    result.stop = stop
    return result


def as_json(rec):
    """A record as JSON reads it back (tuples become lists)."""
    import json

    return json.loads(json.dumps(rec, default=repr))
