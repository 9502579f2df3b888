"""The port's core below the wide path: partition round trips, the
communicator and its blocking collectives (p = 1 and p = 8 against numpy
oracles, world and group), the narrow path and fusion planner (the counters
and explain() of tests/test_fusion.py, held against the JAX package), and
the purity of the package (no jax, no repro at import)."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import comm, tree  # noqa: E402
from repro_torch.core.context import IContext  # noqa: E402
from repro_torch.core.dag import DagEngine  # noqa: E402
from repro_torch.core.partition import (Block, block_aval, concat_blocks,  # noqa: E402
                                        from_host, pad_to, split_block, to_host)
from repro_torch.core.textlambda import ISource, text_lambda  # noqa: E402
from repro_torch.interop import block_from_reference, block_to_numpy  # noqa: E402

CPU = {"ignis.device": "cpu"}
HERE = os.path.dirname(os.path.abspath(__file__))


def tworker(**props):
    return tcore.IWorker(tcore.ICluster(tcore.IProperties({**CPU, **props})), "python")


def jworker(**props):
    return jcore.IWorker(jcore.ICluster(jcore.IProperties(props)), "python")


# ---------------------------------------------------------------------------
# partition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", [1, 3, 8])
def test_from_host_to_host_round_trip(p):
    rows = [{"key": np.int32(i % 5), "value": (np.float32(i / 2), np.int32(i))}
            for i in range(11)]
    b = from_host(rows, p)
    assert b.capacity == max(pad_to(11, p), p) and int(b.valid.sum()) == 11
    back = to_host(b)
    assert [(int(r["key"]), float(r["value"][0]), int(r["value"][1])) for r in back] == \
        [(i % 5, i / 2, i) for i in range(11)]
    assert back[0]["key"].dtype == np.int32 and back[0]["value"][0].dtype == np.float32


def test_from_host_narrows_to_the_references_dtypes():
    b = from_host({"a": np.arange(4, dtype=np.int64), "b": np.ones(4)}, 2)
    assert b.data["a"].dtype == torch.int32 and b.data["b"].dtype == torch.float32
    jb = jcore.IWorker(jcore.ICluster(jcore.IProperties()), "python").parallelize(
        {"a": np.arange(4, dtype=np.int64), "b": np.ones(4)})
    (blk,) = jb.node.result
    assert str(blk.data["a"].dtype) == "int32" and str(blk.data["b"].dtype) == "float32"


def test_concat_split_and_aval():
    b = from_host(np.arange(10, dtype=np.int32), 2)
    parts = split_block(b, 3, 2)
    assert [p.capacity for p in parts] == [4, 4, 2]
    whole = concat_blocks(parts)
    assert torch.equal(whole.data, b.data) and torch.equal(whole.valid, b.valid)
    assert block_aval(b) == block_aval(whole)
    assert block_aval(b) != block_aval(parts[0])
    empty = split_block(from_host(np.arange(2, dtype=np.int32), 2), 3, 2)[2]
    assert empty.capacity == 2 and not bool(empty.valid.any())


def test_interop_round_trip_keeps_rows_in_rank_order():
    data = {"key": np.arange(16, dtype=np.int32), "v": np.arange(32, dtype=np.float32).reshape(16, 2)}
    valid = np.arange(16) % 3 != 0
    b = block_from_reference(data, valid, 8)
    d2, v2 = block_to_numpy(b)
    assert np.array_equal(v2, valid)
    assert all(np.array_equal(d2[k], data[k]) for k in data)
    with pytest.raises(ValueError):
        block_from_reference(data, valid, 5)


def test_tree_flatten_orders_dict_keys_as_jax_does():
    t = {"value": (1, [2, 3]), "key": 0}
    leaves, treedef = tree.flatten(t)
    assert leaves == jax.tree_util.tree_leaves(t)
    assert tree.unflatten(treedef, leaves) == t
    assert tree.map(lambda a, b: a + b, t, t) == {"value": (2, [4, 6]), "key": 0}
    hash(treedef)


# ---------------------------------------------------------------------------
# communicator + blocking collectives vs numpy oracles
# ---------------------------------------------------------------------------

_DTYPES = {"f32": (np.float32, torch.float32), "i32": (np.int32, torch.int32),
           "bool": (np.bool_, torch.bool)}


def _x(n, dt, seed):
    r = np.random.default_rng(seed).integers(-9, 9, n)
    return (r % 2 == 0) if dt == "bool" else r.astype(_DTYPES[dt][0])


def _ctx(p, group):
    ctx = IContext(p, "cpu")
    return ctx.group(range(2, 6)) if group else ctx


@pytest.mark.parametrize("dt", sorted(_DTYPES))
@pytest.mark.parametrize("p,group", [(1, False), (8, False), (8, True)])
def test_collectives_match_numpy(dt, p, group):
    ctx = _ctx(p, group)
    q = ctx.executors
    x = _x(q * q * 3, dt, seed=q)
    t = torch.from_numpy(x)
    # allreduce / reduce over every rank's rows
    sums = comm.allreduce(ctx, t, "sum")
    assert sums.dtype == (torch.int32 if dt != "f32" else torch.float32)
    np.testing.assert_allclose(sums.numpy(), x.sum(axis=0), rtol=1e-6)
    assert comm.allreduce(ctx, t, "max").item() == x.max()
    assert comm.reduce(ctx, t, "min").item() == x.min()
    # gather / bcast / scatter are the identity on one device
    for f in (comm.gather, comm.bcast, comm.scatter, comm.shard_rows, comm.replicate):
        assert np.array_equal(f(ctx, t).numpy(), x)
    # alltoall: rank i's k-row chunk j goes to rank j, slot i
    k = 3
    want = x.reshape(q, q, k).transpose(1, 0, 2).reshape(-1)
    assert np.array_equal(comm.alltoall(ctx, t).numpy(), want)
    # ppermute: rank i's rows to rank i+1
    want = np.roll(x.reshape(q, -1), 1, axis=0).reshape(-1)
    assert np.array_equal(comm.ppermute(ctx, t, 1).numpy(), want)
    # exscan over one scalar per rank
    s = _x(q, dt, seed=5)
    want = np.cumsum(s.astype(np.float64)) - s
    got = comm.exscan(ctx, torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    comm.barrier(ctx)


def test_alltoall_rejects_rows_that_do_not_split():
    with pytest.raises(ValueError, match="alltoall"):
        comm.alltoall(IContext(4, "cpu"), torch.zeros(12))


def test_collective_plans_are_built_once_per_shape_and_communicator():
    ctx = IContext(8, "cpu").group([0, 1, 2, 3])
    x = torch.arange(16, dtype=torch.int32)
    before = comm.comm_stats()
    for _ in range(3):
        comm.allreduce(ctx, x, "max")
    after = comm.comm_stats()
    assert after["coll_calls"] - before["coll_calls"] == 3
    assert after["coll_plan_hits"] - before["coll_plan_hits"] >= 2
    assert after["handles_awaited"] - before["handles_awaited"] == 3


def test_context_groups_split_and_guard():
    ctx = IContext(8, "cpu")
    halves = ctx.split(2)
    assert [g.ranks for g in halves] == [(0, 1, 2, 3), (4, 5, 6, 7)]
    assert halves[1].label() == "data[4:8]" and halves[1].is_group
    with pytest.raises(ValueError, match="evenly"):
        ctx.split(3)
    with pytest.raises(ValueError, match="distinct"):
        ctx.group([1, 1])
    w = tworker(**{"ignis.executor.instances": "8"})
    w.kill_executor(3)
    with pytest.raises(ValueError, match="blacklisted"):
        w.context.group([2, 3])
    w.restore_executor(3)
    assert w.context.group([2, 3]).executors == 2


def test_coll_handle_wait_is_idempotent_and_tracked():
    with comm.track() as pending:
        h = comm.CollHandle("t", None, torch.ones(3), transform=lambda v: v.sum())
        assert pending == [h]
        assert h.test() == (True, 3.0) and h.wait() == 3.0
    assert pending == [] and not h.pending


# ---------------------------------------------------------------------------
# narrow path + fusion planner (tests/test_fusion.py on the port)
# ---------------------------------------------------------------------------


def _chain(df):
    return df.map(lambda x: x * 2).filter(lambda x: x % 3 == 0).map(lambda x: x + 1)


def _explain_shape(text):
    return re.sub(r"#\d+", "#N", text)


def test_maximal_chain_fuses_and_explains_as_the_reference():
    outs = {}
    for name, w in (("jax", jworker()), ("torch", tworker())):
        df = _chain(w.parallelize(np.arange(30, dtype=np.int32)))
        plans = w.engine.plan(df.node)
        assert [n.op for n in plans[df.node].nodes] == ["map", "filter", "map"]
        outs[name] = _explain_shape(df.explain())
    assert outs["torch"] == outs["jax"]
    assert "FusedStage[map -> filter -> map]" in outs["torch"]


def test_single_op_and_boundaries():
    w = tworker()
    df = w.parallelize(np.arange(10, dtype=np.int32)).map(lambda x: x + 1)
    assert w.engine.plan(df.node) == {}
    src = w.parallelize(np.arange(30, dtype=np.int32))
    mid = src.map(lambda x: x * 2).filter(lambda x: x % 3 == 0).cache()
    tail = mid.map(lambda x: x + 1).map(lambda x: x - 5)
    plans = w.engine.plan(tail.node)
    assert [n.op for n in plans[tail.node].nodes] == ["map", "map"]
    assert [n.op for n in plans[mid.node].nodes] == ["map", "filter"]
    tail.count()
    assert mid.node.result is not None
    wide = src.map(lambda x: x % 7).distinct().map(lambda x: x + 1).map(lambda x: x * 3)
    plans = w.engine.plan(wide.node)
    assert [n.op for n in plans[wide.node].nodes] == ["map", "map"] and len(plans) == 1


def test_shared_node_and_map_partitions_are_boundaries():
    w = tworker()
    df = w.parallelize(np.arange(20, dtype=np.int32))
    a = df.map(lambda x: x + 1).map(lambda x: x * 2)
    u = a.map(lambda x: x - 1).union(a.map(lambda x: x + 10))
    plans = w.engine.plan(u.node)
    assert [n.op for n in plans[a.node].nodes] == ["map", "map"] and len(plans) == 1
    assert sorted(int(x) for x in u.collect()) == sorted(
        [2 * (x + 1) - 1 for x in range(20)] + [2 * (x + 1) + 10 for x in range(20)])
    mp = (w.parallelize(np.arange(12, dtype=np.int32)).map(lambda x: x + 1)
          .map_partitions(lambda d: d * 2).map(lambda x: x - 1))
    assert w.engine.plan(mp.node) == {}
    assert sorted(int(x) for x in mp.collect()) == sorted(2 * (x + 1) - 1 for x in range(12))


def test_fusion_disabled_by_property_and_fused_equals_unfused():
    outs = []
    for props in ({}, {"ignis.fusion.enabled": "false"}):
        w = tworker(**props)
        kv = (w.parallelize(np.arange(100, dtype=np.int32), blocks=4)
              .map(lambda x: x * 3).filter(lambda x: x % 2 == 0)
              .map(lambda x: {"key": x % 5, "value": x}).map_values(lambda v: v + 1))
        outs.append(sorted((int(r["key"]), int(r["value"])) for r in kv.collect()))
        fused = w.engine.stats["fused_stages"]
        assert (fused > 0) == (not props)
    assert outs[0] == outs[1]


def test_flatmap_and_sample_fuse():
    w = tworker()
    df = w.parallelize(np.arange(16, dtype=np.int32))

    def fan(x):
        return torch.stack([x, x + 100]), torch.ones((2,), dtype=torch.bool)

    out = df.map(lambda x: x + 1).flatmap(fan, 2).filter(lambda x: x % 2 == 0)
    assert [n.op for n in w.engine.plan(out.node)[out.node].nodes] == \
        ["map", "flatmap", "filter"]
    assert sorted(int(x) for x in out.collect()) == sorted(
        v for x in range(16) for v in (x + 1, x + 101) if v % 2 == 0)
    s = df.map(lambda x: x * 1).sample(0.5, seed=3)
    assert s.node in w.engine.plan(s.node)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_plan_cache_counters_read_as_the_reference(pkg):
    w = jworker() if pkg == "jax" else tworker()
    df = _chain(w.parallelize(np.arange(40, dtype=np.int32), blocks=4))
    df.count()
    s1 = dict(w.engine.stats)
    assert s1["plan_cache_misses"] == 1 and s1["plan_cache_hits"] == 3
    df.count()
    s2 = dict(w.engine.stats)
    assert s2["plan_cache_misses"] == 1 and s2["plan_cache_hits"] == 7


def test_plan_cache_eviction():
    w = tworker(**{"ignis.fusion.plan.cache.size": "1"})
    _chain(w.parallelize(np.arange(8, dtype=np.int32))).count()
    _chain(w.parallelize(np.arange(8, dtype=np.int32)).map(lambda x: x)).count()
    assert w.engine.stats["plan_cache_evictions"] >= 1
    assert len(w.engine._plan_cache) == 1


def test_kill_block_recomputes_only_the_lost_block_through_a_fused_stage():
    w = tworker()
    tail = _chain(w.parallelize(np.arange(40, dtype=np.int32), blocks=4)).persist()
    n = sum(1 for x in range(40) if (2 * x) % 3 == 0)
    assert tail.count() == n
    base = w.engine.stats["block_recomputes"]
    DagEngine.kill_block(tail.node, 2)
    assert tail.count() == n
    assert 1 <= w.engine.stats["block_recomputes"] - base <= 3


def test_sample_is_a_seeded_bernoulli_draw():
    w = tworker()
    df = w.parallelize(np.arange(20000, dtype=np.int32))
    a = [int(x) for x in df.sample(0.3, seed=1).collect()]
    b = [int(x) for x in df.sample(0.3, seed=1).collect()]
    c = [int(x) for x in df.sample(0.3, seed=2).collect()]
    assert a == b and a != c
    assert abs(len(a) / 20000 - 0.3) < 0.02


def test_actions_and_text_lambdas():
    w = tworker(**{"ignis.executor.instances": "4"})
    df = w.parallelize(np.arange(1, 11, dtype=np.int32))
    assert df.map("lambda x: torch.abs(x - 5)").reduce(lambda a, b: a + b, 0) == 25
    assert int(df.max()) == 10 and int(df.min()) == 1
    assert int(df.max(lambda x: -x)) == 1
    assert df.count_by_value()[3] == 1
    assert df.take(3) and len(df.take(3)) == 3
    assert text_lambda("def f(x):\n    return x + 1")(1) == 2
    assert (ISource("app").add_param("k", 3).token()
            == jcore.ISource("app").add_param("k", 3).token())


# ---------------------------------------------------------------------------
# purity: the port imports neither jax nor the reference package
# ---------------------------------------------------------------------------


def test_repro_torch_imports_without_jax_or_repro():
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "# every kernel is CUDA C++ under csrc/: no module holds triton.jit bodies\n"
        "bodies = [n for n in names if n.endswith('._triton')]\n"
        "assert not bodies, bodies\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'triton' not in sys.modules, 'a module imported triton at import time'\n"
        "print('PURE', len(names))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(HERE, "..", "src")
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "PURE" in r.stdout and int(r.stdout.split()[-1]) >= 20


def test_properties_of_unported_subsystems_warn_as_unknown():
    """Every subsystem with properties is ported now: the port registers
    each of the reference's keys, and a key neither package knows warns as
    unknown."""
    from repro.core import properties as jprops
    from repro_torch.core import properties as tprops

    assert set(jprops.REGISTRY) <= set(tprops.REGISTRY)
    key = "ignis.elastic.unknown"
    assert key not in tprops.REGISTRY and key not in jprops.REGISTRY
    tprops._warned_keys.discard(key)
    with pytest.warns(UserWarning, match="unknown property"):
        props = tcore.IProperties({key: "true"})
    assert props.validate() == [f"unknown property {key!r}"]


def test_chip_smoke_imports_neither_jax_nor_repro():
    src = open(os.path.join(HERE, "..", "chip_smoke.py")).read()
    assert not re.search(r"^\s*(import|from)\s+(jax|repro)\b", src, re.M)


def test_block_dataclass_reports_its_device():
    b = Block(torch.zeros(4), torch.ones(4, dtype=torch.bool))
    assert b.device == torch.device("cpu") and b.capacity == 4


@pytest.mark.parametrize("coll", ["alltoall", "ppermute", "allreduce", "gather"])
def test_collective_buffers_are_freed_without_the_cycle_collector(coll):
    """A collective's operand and result go when their last reference does:
    no reference cycle (a recursive closure in ``tree.flatten``) holds them
    until the cyclic collector runs, which on the card kept every exchange
    buffer of a 24-layer expert-parallel prefill alive at once."""
    import gc
    import weakref

    ctx = IContext(8, "cpu", "data")
    was = gc.isenabled()
    gc.disable()
    try:
        x = torch.randn(8 * 8 * 4, 3)
        y = getattr(comm, coll)(ctx, x)
        refs = [weakref.ref(x), weakref.ref(y)]
        del x, y
        assert [r() for r in refs] == [None, None]
        leaves, treedef = tree.flatten({"a": torch.zeros(2), "b": (torch.ones(1),)})
        ref = weakref.ref(leaves[0])
        del leaves
        assert ref() is None and tree.unflatten(treedef, [1, 2]) == {"a": 1, "b": (2,)}
    finally:
        if was:
            gc.enable()
