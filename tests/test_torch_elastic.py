"""The port's elastic mesh, held against the JAX package.

At p = 8 (the JAX package in a subprocess, tests/_torch_recovery_main.py):
the group reshards of a frame consumed on a group — the count the port got
wrong before blocks recorded the ranks they are committed to — and the
conformance tier of tests/_elastic_main.py: every action kind across
``grow(2)`` and ``shrink(2)``, bit-identical to the static run with exact
``reshard_*`` counters, a live job spanning resizes, the groups cache
rebuilt for the new world, capacity memory keyed per world size, the
policy on a live worker, seeded join/leave sequences and retiring named
ranks. At p = 1, in this process: resize validation, the pure planner and
mover against the reference's, the ``ignis.elastic.*`` properties, the
fault-plan sugar, and ``ElasticPolicy``'s decisions against the
reference's on the same queue-depth sequences.

The port's cluster takes its rank slots as an argument (``ICluster(props,
slots=8)``), where the JAX package grows onto the process's devices.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_recovery_cases as cases  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.core import properties as jprops  # noqa: E402
from repro.distributed import elastic as jel  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core import properties as tprops  # noqa: E402
from repro_torch.core.partition import Block, block_ranks  # noqa: E402
from repro_torch.distributed import elastic as tel  # noqa: E402

CPU = {"ignis.device": "cpu"}


@pytest.fixture(scope="module", autouse=True)
def jax_p8(tmp_path_factory):
    ref = cases.start_reference("elastic", tmp_path_factory.mktemp("elastic") / "p8.json")
    yield ref
    ref.stop()


@pytest.mark.parametrize("case,expect", [("world", 1), ("other", 1), ("own", 0)])
def test_group_reshards_count_as_the_reference(case, expect, jax_p8):
    """A frame persisted on the world, on group 1, or on group 0, consumed
    by a reduceByKey on group 0 at p = 8: the shuffle's ``group_reshards``
    and the job scheduler's overlay count what the reference counts."""
    got = cases.as_json(cases.e_group_reshards(cases.Pkg("torch", 8), 8, case))
    want = jax_p8()[f"group_reshards_{case}"]
    assert want["shuffle"] == expect and want["scheduler"] == expect
    assert (got["shuffle"], got["scheduler"]) == (want["shuffle"], want["scheduler"])
    assert got == want


@pytest.mark.parametrize("name", sorted(cases.ELASTIC_P8))
def test_p8_matches_jax(name, jax_p8):
    got = cases.as_json(cases.ELASTIC_P8[name](cases.Pkg("torch", 8), 8))
    want = jax_p8()[name]
    assert not cases.held(want), cases.held(want)
    assert got == want


def test_p8_conformance_counters_of_the_reference_suite(jax_p8):
    """The exact counters tests/_elastic_main.py asserts: 4 world blocks
    moved and the group-pinned one kept on grow(2); 9 moves and 2 kept
    after shrink(2); no recompute; every action kind bit-identical."""
    rec = cases.as_json(cases.e_conformance(cases.Pkg("torch", 8), 8))
    g, s = rec["after_grow"], rec["after_shrink"]
    assert (g["reshard_moves"], g["reshard_unchanged"], g["reshard_recomputes"]) == (4, 1, 0)
    assert (s["reshard_moves"], s["reshard_unchanged"], s["reshard_recomputes"]) == (9, 2, 0)
    assert all(rec["grow_same"].values()) and all(rec["shrink_same"].values())
    assert rec["grow_recomputes"] == [0, 0] and rec["shrink_recomputes"] == 0
    assert rec["g_devs0"] == rec["g_devs_grow"] == [0, 1]
    assert rec["groups6"] == [[0, 1, 2], [3, 4, 5]] and rec["groups_rebuilt"]


# ---------------------------------------------------------------------------
# resize validation at p = 1 (one slot: no grow; one survivor at least)
# ---------------------------------------------------------------------------

def _worker(p=1, slots=None):
    return tcore.IWorker(tcore.ICluster(tcore.IProperties(
        {**CPU, "ignis.executor.instances": str(p)}), slots=slots), "python")


def test_grow_without_free_slots_raises():
    w = _worker()
    with pytest.raises(ValueError, match="free rank slot"):
        w.grow(1)
    with pytest.raises(ValueError):
        w.grow(0)
    with pytest.raises(ValueError, match="rank slots"):
        tcore.ICluster(tcore.IProperties({**CPU, "ignis.executor.instances": "4"}), slots=2)


def test_shrink_validation():
    w = _worker(4, slots=4)
    for bad in (4, [99], []):
        with pytest.raises(ValueError):
            w.shrink(bad)
    assert w.executors == 4


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_resize_same_world_rebuilds_context(pkg):
    """Same world, new base context: world partitions re-spread and the
    counters move alike in both packages."""
    if pkg == "jax":
        w = jcore.IWorker(jcore.ICluster(jcore.IProperties()), "python")
        world = w._world_devices()
    else:
        w = _worker()
        world = w._world_ranks()
    df = w.parallelize(np.arange(16, dtype=np.int32)).persist()
    assert df.count() == 16
    old = w._base_context
    assert w._resize(world) == w.executors
    assert w._base_context is not old
    st = w.metrics("elastic")
    assert (st["reshard_moves"], st["reshard_recomputes"], st["shrinks"]) == (1, 0, 1)
    assert sorted(int(x) for x in df.collect()) == list(range(16))


def test_groups_cache_revalidates_on_new_base_context():
    w = _worker()
    gs = w.groups(1)
    assert w.groups(1)[0] is gs[0]
    w._resize(w._world_ranks())
    gs2 = w.groups(1)
    assert gs2[0] is not gs[0] and gs2[0].parent is w._base_context


def test_new_world_binds_new_frames_and_groups():
    w = _worker(2, slots=4)
    assert w.grow(2) == 4 and w.context.ranks == (0, 1, 2, 3)
    df = w.parallelize(np.arange(10, dtype=np.int32))
    assert block_ranks(df.node.result[0]) == frozenset(range(4))
    assert [g.ranks for g in w.groups(2)] == [(0, 1), (2, 3)]
    assert w.shrink([0]) == 3 and w.context.ranks == (1, 2, 3)
    assert [g.ranks for g in w.groups(3)] == [(1,), (2,), (3,)]


# ---------------------------------------------------------------------------
# the pure planner and mover
# ---------------------------------------------------------------------------

SETS = [None, frozenset({0, 1}), frozenset({2, 3}), frozenset({0, 1, 2, 3}),
        frozenset({7}), frozenset({0, 1, 2, 3, 4, 5})]
WORLDS = [(frozenset({0, 1, 2, 3}), frozenset({0, 1, 2, 3, 4, 5})),
          (frozenset({0, 1, 2, 3}), frozenset({0, 1})),
          (frozenset({0, 1, 2, 3, 4, 5}), frozenset({0, 1, 2, 3}))]


@pytest.mark.parametrize("old,new", WORLDS)
def test_plan_reshard_matches_the_reference(old, new):
    for s in SETS:
        assert tel.plan_reshard(s, old, new) == jel.plan_reshard(s, old, new), (s, old, new)
    assert tel.plan_reshard(frozenset({0, 1}), old, new) == "keep"
    assert tel.plan_reshard(old, old, new) == "move"


@pytest.mark.parametrize("p", [3, 4, 8])
def test_repad_block_keeps_rows_in_rank_order(p):
    w = _worker(2, slots=8)
    df = w.parallelize(np.arange(10, dtype=np.int32))
    blk = df.node.result[0]
    ctx = tcore.IContext(tuple(range(p)), "cpu", "data")
    out = tel.repad_block(blk, p, ctx)
    assert isinstance(out, Block)
    assert out.capacity % p == 0 and out.capacity >= blk.capacity
    assert out.ranks == tuple(range(p))
    valid = out.valid.numpy()
    assert valid.sum() == 10
    assert np.array_equal(out.data.numpy()[valid], np.arange(10))
    assert np.array_equal(out.data.numpy()[:blk.capacity], blk.data.numpy())


# ---------------------------------------------------------------------------
# restore_elastic: a train state saved under one mesh, placed for another
# (tests/_elastic_main.py, tests/test_elastic.py, tests/test_checkpoint.py)
# ---------------------------------------------------------------------------

def _olmo_state(seed=1):
    """The reduced OLMo's params and AdamW state in the JAX tree, on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import checkpoint_tree
    from repro_torch.models import build_model

    cfg = get_config("olmo-1b").reduced()
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(seed))
    return cfg, checkpoint_tree(params, bundle.init_opt(params))


def _leaves(t):
    from repro_torch.core import tree

    return tree.leaves(t)


def _same(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _jax_specs(tree, cfg, shape):
    from repro.distributed import sharding as js
    from repro_torch.interop import _tree_numpy

    class StandIn:
        axis_names = ("data", "model")

    m = StandIn()
    m.shape = dict(zip(m.axis_names, shape))
    host = _tree_numpy(tree)
    psp = js.param_specs(host["params"], cfg, m)
    return {"params": psp, "opt": js.opt_specs(host["opt"], psp, cfg, m)}


def _spec_tree(placement):
    from repro_torch.core import tree

    return tree.map(lambda pl: tuple(pl.spec), placement)


def _jax_spec_tree(specs):
    return jax.tree.map(tuple, specs, is_leaf=lambda s: not isinstance(s, dict))


@pytest.mark.parametrize("saved,restored", [((8, 1), (4, 1)), ((4, 1), (8, 1)),
                                            ((4, 1), (5, 1)), ((8, 1), (4, 2))])
def test_restore_elastic_across_meshes(tmp_path, saved, restored):
    """8 → 4, 4 → 8, the uneven world of 5 (its specs replicate) and
    8 → (4, 2): every leaf back bit for bit, placed by the specs of the
    mesh it was restored for."""
    from repro_torch.checkpoint import save
    from repro_torch.launch.mesh import make_local_mesh

    cfg, state = _olmo_state()
    cfg = cfg.with_overrides(sharding_preset="fsdp_tp_zero1")
    save(str(tmp_path), 1, state)  # placed under `saved`, then saved from there
    placed = tel.restore_elastic(str(tmp_path), 1, cfg, make_local_mesh(*saved, device="cpu"),
                                 state)
    save(str(tmp_path), 2, dict(placed))
    out = tel.restore_elastic(str(tmp_path), 2, cfg, make_local_mesh(*restored, device="cpu"),
                              state)
    assert set(out) == {"params", "opt"}
    assert _same(out, state)
    assert all(t.device == torch.device("cpu") for t in _leaves(out))
    assert out.mesh == make_local_mesh(*restored, device="cpu")
    assert _spec_tree(out.placement) == _jax_spec_tree(_jax_specs(state, cfg, restored))


def test_restore_elastic_rejects_shape_mismatch(tmp_path):
    from repro_torch.checkpoint import save
    from repro_torch.launch.mesh import make_local_mesh

    cfg, state = _olmo_state()
    save(str(tmp_path), 1, {"params": state["params"]})
    bad = {"params": _map(lambda x: x[..., : max(1, x.shape[-1] // 2)], state["params"])}
    with pytest.raises(ValueError, match="checkpoint"):
        tel.restore_elastic(str(tmp_path), 1, cfg, make_local_mesh(1, 1, device="cpu"), bad)
    with pytest.raises(ValueError, match="checkpoint"):
        tel.restore_elastic(str(tmp_path), 1, cfg, make_local_mesh(8, 1, device="cpu"), bad)


def _map(fn, t):
    from repro_torch.core import tree

    return tree.map(fn, t)


def test_restore_elastic_single_rank_params_and_opt(tmp_path):
    """tests/test_checkpoint.py's single-device restore, params and opt."""
    from repro_torch.checkpoint import save
    from repro_torch.launch.mesh import make_local_mesh

    cfg, state = _olmo_state(seed=0)
    save(str(tmp_path), 3, state)
    out = tel.restore_elastic(str(tmp_path), 3, cfg, make_local_mesh(1, 1, device="cpu"),
                              {"params": state["params"], "opt": state["opt"]})
    assert _same(out, state)
    assert all(pl.rank_bytes == t.numel() * t.element_size()
               for pl, t in zip(_leaves(out.placement), _leaves(out), strict=True))


def test_restore_elastic_takes_a_tree_saved_by_jax(tmp_path):
    """A train state saved by the JAX package restores in the port, bit for
    bit, with meta leaves as the target (shapes alone)."""
    import jax.numpy as jnp

    from repro.checkpoint import save as jsave
    from repro_torch.interop import _tree_numpy
    from repro_torch.launch.mesh import make_local_mesh

    cfg, state = _olmo_state()
    jsave(str(tmp_path), 5, jax.tree.map(jnp.asarray, _tree_numpy(state)))
    target = _map(lambda t: t.to("meta"), state)
    out = tel.restore_elastic(str(tmp_path), 5, cfg, make_local_mesh(4, 2, device="cpu"),
                              target)
    assert _same(out, state)


def test_policy_restore_places_on_the_live_world(tmp_path):
    """``ElasticPolicy.restore`` places onto the worker's CURRENT world: the
    one-axis mesh of its context, after a grow and after a shrink."""
    from repro_torch.checkpoint import save
    from repro_torch.launch.mesh import Mesh

    cfg, state = _olmo_state()  # the reduced config's preset: dp
    save(str(tmp_path), 2, {"params": state["params"]})
    w = _worker(2, slots=8)
    pol = tel.ElasticPolicy(w, props=_props(enabled="false"))
    for resize in (lambda: None, lambda: w.grow(2), lambda: w.shrink(3)):
        resize()
        out = pol.restore(str(tmp_path), 2, cfg, {"params": state["params"]})
        assert _same(out["params"], state["params"])
        assert out.mesh == Mesh.of_context(w.context)
        assert out.mesh.shape == {"data": w.executors}
        assert all(tuple(pl.spec) == () for pl in _leaves(out.placement["params"]))


def test_a_spec_naming_an_axis_the_mesh_lacks_raises(tmp_path):
    """The rules name "model" wherever it divides, and an absent axis has
    size 1: on the worker's one-axis mesh an fsdp preset names it, which
    JAX's ``NamedSharding`` refuses, and so does the port's placement."""
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from repro.core import compat
    from repro_torch.checkpoint import save

    cfg, state = _olmo_state()
    save(str(tmp_path), 2, {"params": state["params"]})
    pol = tel.ElasticPolicy(_worker(), props=_props(enabled="false"))
    with pytest.raises(ValueError, match="model"):
        pol.restore(str(tmp_path), 2, cfg.with_overrides(sharding_preset="fsdp"),
                    {"params": state["params"]})
    with pytest.raises(ValueError, match="model"):
        NamedSharding(compat.make_mesh((1,), ("data",)), JP("model", "data"))


# ---------------------------------------------------------------------------
# properties and the fault-plan sugar
# ---------------------------------------------------------------------------

ELASTIC_KEYS = ("enabled", "min.executors", "max.executors", "step",
                "queue.per.executor", "cooldown.polls")


@pytest.mark.parametrize("key", ELASTIC_KEYS)
def test_elastic_props_registered_as_the_reference(key):
    k = f"ignis.elastic.{key}"
    a, b = jprops.REGISTRY[k], tprops.REGISTRY[k]
    assert (b.type, b.default, b.doc) == (a.type, a.default, a.doc)


def test_elastic_prop_reads():
    p = tcore.IProperties()
    assert p.get_bool("ignis.elastic.enabled", False) is False
    p["ignis.elastic.step"] = "3"
    assert p.get_int("ignis.elastic.step") == 3
    assert p.validate() == []


def test_fail_elastic_reshard_sugar():
    plan = tfaults.FaultPlan().fail_elastic_reshard(op="map", block=2)
    with tfaults.inject(plan):
        tfaults.check("elastic.reshard", op="sort", block=2)
        tfaults.check("elastic.reshard", op="map", block=1)
        with pytest.raises(tfaults.FaultInjected):
            tfaults.check("elastic.reshard", op="map", block=2)
        tfaults.check("elastic.reshard", op="map", block=2)
    assert plan.injections("elastic.reshard") == 1


# ---------------------------------------------------------------------------
# ElasticPolicy against the reference's decisions
# ---------------------------------------------------------------------------

def _props(**kv):
    return tcore.IProperties({f"ignis.elastic.{k.replace('_', '.')}": str(v)
                              for k, v in kv.items()})


def _jprops(**kv):
    return jcore.IProperties({f"ignis.elastic.{k.replace('_', '.')}": str(v)
                              for k, v in kv.items()})


def test_policy_disabled_records_denied():
    w = _worker(1, slots=8)
    pol = tel.ElasticPolicy(w, props=_props(enabled="false"))
    assert pol.max == 8  # max 0: every rank slot
    assert pol.poll(queue_depth=10_000) == 0 and w.executors == 1
    assert pol.stats["denied"] == 1
    assert pol.on_admit(8) == 0 and pol.stats["denied"] == 2


def test_policy_desired_clamps():
    kw = dict(enabled="true", min_executors=2, max_executors=6, queue_per_executor=4)
    pol = tel.ElasticPolicy(_worker(), props=_props(**kw))
    ref = jel.ElasticPolicy(None, props=_jprops(**kw))
    for depth in (0, 12, 10_000, -5, 7, 24, 25):
        assert pol.desired(depth) == ref.desired(depth)
    assert [pol.desired(d) for d in (0, 12, 10_000, -5)] == [2, 3, 6, 2]


def test_policy_reads_scheduler_queue_depth():
    w = _worker()
    assert w.parallelize(np.arange(8, dtype=np.int32)).count() == 8
    pol = tel.ElasticPolicy(w, props=_props(enabled="false"))
    assert pol.scheduler().queue_depth() == 0
    assert pol.poll() == 0


class _FakeWorker:
    """Only ``executors``, ``grow`` and ``shrink``: the state machine is what
    is under test."""

    def __init__(self, p):
        self.executors = p

    def grow(self, n):
        self.executors += n
        return self.executors

    def shrink(self, n):
        self.executors -= n
        return self.executors


def _policy_pair(p0, **kw):
    t, j = _FakeWorker(p0), _FakeWorker(p0)
    return (t, tel.ElasticPolicy(t, props=_props(**kw)),
            j, jel.ElasticPolicy(j, props=_jprops(**kw)))


@pytest.mark.parametrize("seed", range(6))
def test_policy_matches_the_reference_on_seeded_sequences(seed):
    r = np.random.default_rng(seed)
    kw = dict(enabled="true", min_executors=1, max_executors=8,
              step=int(r.integers(1, 4)), cooldown_polls=int(r.integers(1, 4)),
              queue_per_executor=int(r.integers(1, 9)))
    t, tp, j, jp = _policy_pair(int(r.integers(1, 5)), **kw)
    for depth in r.integers(0, 200, 30):
        assert tp.poll(queue_depth=int(depth)) == jp.poll(queue_depth=int(depth))
        assert t.executors == j.executors
    assert dict(tp.stats) == dict(jp.stats)


try:
    from hypothesis import HealthCheck, given, settings, strategies as st
    HAVE_HYP = True
except ImportError:  # pragma: no cover - dev-only dependency
    HAVE_HYP = False

if HAVE_HYP:
    _settings = settings(max_examples=25, deadline=None,
                         suppress_health_check=list(HealthCheck))

    @given(st.integers(1, 4), st.integers(1, 3), st.integers(1, 3),
           st.integers(1, 8),
           st.lists(st.integers(0, 200), min_size=1, max_size=30))
    @_settings
    def test_policy_poll_matches_the_reference(p0, step, cooldown, queue_per, depths):
        t, tp, j, jp = _policy_pair(p0, enabled="true", min_executors=1, max_executors=8,
                                    step=step, cooldown_polls=cooldown,
                                    queue_per_executor=queue_per)
        for depth in depths:
            assert tp.poll(queue_depth=depth) == jp.poll(queue_depth=depth)
            assert t.executors == j.executors and 1 <= t.executors <= 8
        assert dict(tp.stats) == dict(jp.stats)

    @given(st.integers(1, 6), st.integers(1, 8), st.integers(1, 8))
    @_settings
    def test_policy_on_admit_matches_the_reference(p0, tenants, mx):
        t, tp, j, jp = _policy_pair(p0, enabled="true", min_executors=1, max_executors=mx)
        assert tp.on_admit(tenants) == jp.on_admit(tenants)
        assert t.executors == j.executors == max(p0, max(1, min(mx, tenants)))

    _sets = st.sets(st.integers(0, 9), max_size=8).map(frozenset)

    @given(_sets, _sets, st.one_of(st.none(), _sets.filter(lambda s: s)))
    @_settings
    def test_plan_reshard_invariants_match_the_reference(old_world, new_world, ranks):
        plan = tel.plan_reshard(ranks, old_world, new_world)
        assert plan == jel.plan_reshard(ranks, old_world, new_world)
        if plan == "keep":
            assert ranks is not None and ranks <= new_world
            assert not (ranks & (old_world - new_world)) and ranks != old_world
