"""Cases run alike by the JAX package and the torch port, for
tests/test_torch_comm_plans.py and tests/test_torch_apps.py.

``comm_script`` drives every call shape of every collective (blocking,
``i*`` and persistent) through one communicator and records, per call, the
result and the change of the ``comm_stats()`` counters. ``spmd_apps`` runs
the stencil and CG programs, natively and through ``worker.call``. Both
take a small adapter (``put``/``get``) so one definition serves both
packages; tests/_torch_apps_main.py runs them at p = 8 on fake XLA devices.
"""
from __future__ import annotations

import numpy as np

COUNTERS = ("coll_calls", "coll_plan_hits", "coll_plan_misses",
            "handles_created", "handles_awaited")

DTYPES = {
    "f32": lambda n: (np.arange(n) * 1.25 - 3.0).astype(np.float32),
    "i32": lambda n: (np.arange(n) * 7 % 23 - 11).astype(np.int32),
    "bool": lambda n: (np.arange(n) % 3 == 0),
}
OPS = ("max", "min", "sum")


def _delta(comm, before):
    after = comm.comm_stats()
    return {k: after[k] - before[k] for k in COUNTERS}


def comm_script(comm, ctx, put, get):
    """Every collective and call shape on ``ctx``; returns
    ``[(step, result as numpy or None, counter deltas)]``. ``put`` turns a
    host array into an operand on the communicator, ``get`` an operand
    back into numpy."""
    p = ctx.executors
    n = p * p * 2
    out = []

    def step(name, fn):
        before = comm.comm_stats()
        v = fn()
        out.append((name, None if v is None else get(v), _delta(comm, before)))

    for dt, make in DTYPES.items():
        x = put(make(n))
        for op in OPS:
            if (dt, op) == ("bool", "sum"):
                continue
            step(f"allreduce/{dt}/{op}", lambda: comm.allreduce(ctx, x, op))
            step(f"iallreduce/{dt}/{op}", lambda: comm.iallreduce(ctx, x, op).wait())
            plan = []
            step(f"persistent-init/{dt}/{op}",
                 lambda: plan.append(comm.persistent(ctx, "allreduce", x, op=op)))
            step(f"persistent-call/{dt}/{op}", lambda: plan[0](x))
            step(f"persistent-start/{dt}/{op}", lambda: plan[0].start(x).wait())
            step(f"reduce/{dt}/{op}", lambda: comm.reduce(ctx, x, op))
            step(f"ireduce/{dt}/{op}", lambda: comm.ireduce(ctx, x, op).wait())
        for coll in ("bcast", "scatter", "gather", "alltoall", "ppermute"):
            blocking, nonblocking = getattr(comm, coll), getattr(comm, "i" + coll)
            step(f"{coll}/{dt}", lambda: blocking(ctx, x))
            step(f"i{coll}/{dt}", lambda: nonblocking(ctx, x).wait())
            plan = (comm.persistent(ctx, coll) if coll in ("bcast", "scatter")
                    else comm.persistent(ctx, coll, x))
            step(f"persistent-{coll}/{dt}", lambda: plan(x))
        step(f"ppermute3/{dt}", lambda: comm.ippermute(ctx, x, 3).wait())
        step(f"persistent-ppermute3/{dt}",
             lambda: comm.persistent(ctx, "ppermute", x, shift=3).start(x).wait())
    for dt in ("f32", "i32"):
        s = put(DTYPES[dt](p))
        step(f"exscan/{dt}", lambda: comm.exscan(ctx, s))
        step(f"iexscan/{dt}", lambda: comm.iexscan(ctx, s).wait())
        step(f"persistent-exscan/{dt}", lambda: comm.persistent(ctx, "exscan", s)(s))
    step("barrier", lambda: comm.barrier(ctx))
    step("ibarrier", lambda: comm.ibarrier(ctx).wait())
    step("persistent-barrier", lambda: comm.persistent(ctx, "barrier")())
    xs = [put(np.full(n, i, np.float32)) for i in range(4)]
    step("wait-out-of-order", lambda: np.stack(
        [np.asarray(get(h.wait())) for h in
         reversed([comm.iallreduce(ctx, v) for v in xs])]))
    step("wait_all", lambda: np.stack([np.asarray(get(v)) for v in comm.wait_all(
        [comm.iallreduce(ctx, v) for v in xs])]))
    return out


def spmd_apps(stencil, comm_pair, p, put, get, call=None):
    """The stencil and CG programs natively over ``comm_pair`` (what
    ``ctx.comm()`` gives: the mesh and axis in the reference, the ranks and
    axis in the port) of ``p`` ranks and, given ``call(app, x, iters)`` (a
    worker.call → host array), framework-wrapped."""
    g = np.random.default_rng(0).normal(size=(4 * p, 12)).astype(np.float32)
    b = np.random.default_rng(1).normal(size=16 * p).astype(np.float32)
    out = {"stencil": get(stencil.stencil_native(*comm_pair, put(g), 7)),
           "cg": get(stencil.cg_native(*comm_pair, put(b), 12))}
    if call is not None:
        out["stencil_app"] = call("stencil_app", g, 7)
        out["cg_app"] = call("cg_app", b, 12)
    return out, g, b
