"""The port's collective call shapes against the JAX package's: blocking,
nonblocking ``i*`` handles, ``persistent`` plans (``CollPlan.start``) and
``persistent_program``. Every call's result must equal the reference's bit
for bit (dtype, shape, values) and every ``comm_stats()`` counter must move
as the reference's does, call for call — at p = 1 in this process (world
and a group) and at p = 8 (world and a group of 4) against the reference
run on 8 fake XLA devices in a subprocess (tests/_torch_apps_main.py).
Also the port's twins of tests/test_collectives.py's dispatch-time
validation, handle and plan-cache cases."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_apps_cases as cases  # noqa: E402
import repro.core as jcore  # noqa: E402
from repro.core import comm as jcomm  # noqa: E402
from repro_torch.core import comm  # noqa: E402
from repro_torch.core.context import IContext  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def _get(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _put(a):
    return torch.from_numpy(np.asarray(a))


def _torch_ctx(p, kind):
    ctx = IContext(p, "cpu")
    return ctx if kind == "world" else ctx.group(range(max(p // 2, 1)))


def _torch_script(p, kind):
    comm.engine().clear()
    return cases.comm_script(comm, _torch_ctx(p, kind), _put, _get)


def _assert_bits(got, exp, what):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.dtype == exp.dtype, (what, got.dtype, exp.dtype)
    assert got.shape == exp.shape, (what, got.shape, exp.shape)
    assert np.array_equal(got, exp), (what, got, exp)


@pytest.fixture(scope="module")
def jax_p8(tmp_path_factory):
    """The reference's script at p = 8, run once per module in a subprocess."""
    out = tmp_path_factory.mktemp("comm_plans") / "jax_p8.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, os.path.join(HERE, "_torch_apps_main.py"),
                        str(out)], env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "TORCH_APPS_JAX_OK" in r.stdout, r.stderr[-3000:]
    z = np.load(out)
    return json.loads(str(z["steps"])), {k: z[k] for k in z.files if k != "steps"}


@pytest.mark.parametrize("kind", ["world", "group"])
def test_p1_every_call_shape_matches_the_reference(kind):
    """Results bit for bit and counter deltas call for call, p = 1."""
    jw = jcore.IWorker(jcore.ICluster(jcore.IProperties()), "python")
    jctx = jw.context if kind == "world" else jw.context.group([0])
    jcomm.engine().clear()
    want = cases.comm_script(jcomm, jctx, lambda a: jcomm.shard_rows(jctx, a), np.asarray)
    got = _torch_script(1, kind)
    assert [s for s, _v, _d in got] == [s for s, _v, _d in want]
    for (step, gv, gd), (_s, wv, wd) in zip(got, want):
        assert (gv is None) == (wv is None), step
        if gv is not None:
            _assert_bits(gv, wv, step)
        assert gd == wd, (step, gd, wd)


@pytest.mark.parametrize("kind", ["world", "group"])
def test_p8_every_call_shape_matches_the_reference(kind, jax_p8):
    """The same at p = 8 (world, and a group of the first 4 ranks), against
    the reference on 8 devices."""
    steps, arrays = jax_p8
    want = steps[kind]
    got = _torch_script(8, kind)
    assert [s for s, _v, _d in got] == [s for s, _d in want]
    for i, ((step, gv, gd), (_s, wd)) in enumerate(zip(got, want)):
        key = f"{kind}|{i}"
        assert (gv is None) == (key not in arrays), step
        if gv is not None:
            _assert_bits(gv, arrays[key], step)
        assert gd == wd, (step, gd, wd)


# ---------------------------------------------------------------------------
# twins of tests/test_collectives.py (dispatch, handles, plan cache)
# ---------------------------------------------------------------------------


class _FakeCtx:
    executors = 4
    axis = "data"


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_ialltoall_rejects_indivisible_rows_at_dispatch(pkg):
    """The i* variant raises at DISPATCH (handle creation), not at wait, in
    both packages, and so does the persistent plan's init."""
    c, arange = ((comm, lambda n: torch.arange(n, dtype=torch.int32)) if pkg == "torch"
                 else (jcomm, lambda n: jnp.arange(n, dtype=jnp.int32)))
    before = c.comm_stats()
    with pytest.raises(ValueError, match="divisible"):
        c.ialltoall(_FakeCtx(), arange(6))
    with pytest.raises(ValueError, match="divisible"):
        c.persistent(_FakeCtx(), "alltoall", arange(8))
    after = c.comm_stats()
    assert {k: after[k] - before[k] for k in cases.COUNTERS} == dict.fromkeys(
        cases.COUNTERS, 0)  # nothing entered flight


@pytest.mark.parametrize("p", [1, 8])
def test_unknown_ops_rejected(p):
    ctx = IContext(p, "cpu")
    x = torch.arange(2 * p, dtype=torch.int32)
    with pytest.raises(ValueError, match="allreduce op"):
        comm.allreduce(ctx, x, op="prod")
    with pytest.raises(ValueError, match="allreduce op"):
        comm.persistent(ctx, "reduce", x, op="prod")
    with pytest.raises(ValueError, match="exscan"):
        comm.iexscan(ctx, x, op="max")
    with pytest.raises(ValueError, match="unknown collective"):
        comm.persistent(ctx, "alltoallv", x)
    with pytest.raises(ValueError, match="prototype"):
        comm.persistent(ctx, "allreduce")


@pytest.mark.parametrize("p", [1, 8])
def test_handle_wait_is_idempotent(p):
    ctx = IContext(p, "cpu")
    x = torch.arange(8 * p, dtype=torch.float32)
    before = comm.comm_stats()
    h = comm.iallreduce(ctx, x)
    assert h.pending
    v1 = h.wait()
    v2 = h.wait()  # double-wait: same completed value, no re-dispatch
    assert v1 is v2 and h.done() and not h.pending
    ok, v3 = h.test()
    assert ok and v3 is v1
    after = comm.comm_stats()
    assert after["coll_calls"] - before["coll_calls"] == 1
    assert after["handles_awaited"] - before["handles_awaited"] == 1
    _assert_bits(v1.numpy(), np.float32(np.arange(8 * p).sum()), "iallreduce")


@pytest.mark.parametrize("p", [1, 8])
def test_handle_test_and_chain(p):
    ctx = IContext(p, "cpu")
    x = torch.arange(8 * p, dtype=torch.float32)
    h = comm.igather(ctx, x).chain(lambda v: v.numpy() + 1)
    _assert_bits(h.wait(), np.arange(8 * p, dtype=np.float32) + 1, "chain")
    # chaining a completed handle applies immediately
    h2 = comm.igather(ctx, x)
    h2.wait()
    _assert_bits(h2.chain(lambda v: v.numpy() * 2).wait(),
                 np.arange(8 * p, dtype=np.float32) * 2, "chain after wait")
    # on the CPU nothing is in flight: test() completes at once
    assert comm.ippermute(ctx, x).test()[0]


@pytest.mark.parametrize("p", [1, 8])
def test_wait_all_and_out_of_order(p):
    ctx = IContext(p, "cpu")
    xs = [torch.full((4 * p,), float(i)) for i in range(6)]
    handles = [comm.iallreduce(ctx, x) for x in xs]
    # await in reverse — completion order must not affect values
    for i in reversed(range(6)):
        _assert_bits(handles[i].wait().numpy(), np.float32(4 * p * i), "reverse")
    got = comm.wait_all([comm.iallreduce(ctx, x) for x in xs])
    for i, v in enumerate(got):
        _assert_bits(v.numpy(), np.float32(4 * p * i), "wait_all")


@pytest.mark.parametrize("p", [1, 8])
def test_plan_cache_hits_and_identical_results(p):
    """Init-once/invoke-many: the second persistent() for the same (coll,
    aval, communicator) is a cache HIT and returns identical bits."""
    ctx = IContext(p, "cpu")
    x = torch.arange(16 * p, dtype=torch.float32)
    comm.persistent(ctx, "allreduce", x)  # warm, whatever ran before
    before = comm.comm_stats()
    a = comm.persistent(ctx, "allreduce", x)(x)
    mid = comm.comm_stats()
    b = comm.persistent(ctx, "allreduce", x).start(x).wait()
    after = comm.comm_stats()
    _assert_bits(a.numpy(), b.numpy(), "persistent")
    assert mid["coll_plan_hits"] - before["coll_plan_hits"] == 1
    assert after["coll_plan_hits"] - mid["coll_plan_hits"] == 1
    assert after["coll_plan_misses"] == before["coll_plan_misses"]
    assert after["coll_calls"] - before["coll_calls"] == 2
    # another communicator over other ranks never reuses the plan
    comm.persistent(ctx.group(range(max(p // 2, 1))) if p > 1 else IContext(1, "cpu", "other"),
                    "allreduce", x[:16 * max(p // 2, 1)])
    assert comm.comm_stats()["coll_plan_misses"] == after["coll_plan_misses"] + 1


def test_persistent_program_counts_as_the_reference():
    """A whole SPMD program is built once per (tag, statics, communicator):
    the port's and the reference's counters move alike over the same
    sequence of lookups."""
    tw = IContext(1, "cpu")
    jw = jcore.IWorker(jcore.ICluster(jcore.IProperties()), "python").context
    seq = [("t", (1,)), ("t", (1,)), ("t", (2,)), ("u", (1,)), ("t", (1,))]
    deltas = {}
    for name, c, key in (("torch", comm, tw.comm()), ("jax", jcomm, jw.mesh)):
        c.engine().clear()
        before = c.comm_stats()
        built = []
        for tag, statics in seq:
            fn = c.persistent_program(tag, key, statics,
                                      lambda s=statics: built.append(s) or (lambda v: v + s[0]))
        assert len(built) == 3
        if name == "torch":
            assert torch.equal(fn(torch.ones(2)), torch.full((2,), 2.0))
        after = c.comm_stats()
        deltas[name] = {k: after[k] - before[k] for k in cases.COUNTERS}
    assert deltas["torch"] == deltas["jax"] == {
        "coll_calls": 0, "coll_plan_hits": 2, "coll_plan_misses": 3,
        "handles_created": 0, "handles_awaited": 0}


def test_blocking_facades_have_no_private_dispatch_left():
    """Every blocking collective is i*(…).wait(): the old one-shot blocking
    dispatch is gone."""
    assert not hasattr(comm, "_run")
