"""The port's streaming ingestion, held against the JAX package: replayable
sources (the same rows from the same offsets), admission decisions, the
pump's exact offsets, backpressure bound and in-order commits, tenant
isolation against solo runs, offset checkpoints whose restart is bit
identical and skips and replays nothing, the shed policy, the front end's
elastic hook, and one scheduler shared by a pump and the serve front door.

Each pump case runs on both packages and compares states and stats; at
p = 1 in this process, and at p = 8 (4 tenants on ``worker.groups(4)``, the
front end growing the world on admission) against the JAX package in a
subprocess (tests/_torch_recovery_main.py). ``IteratorSource`` is fed a
plain generator and, as in the reference's tests, the data pipeline's
packed rows.
"""
import os
import sys
import threading
from collections import deque

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_recovery_cases as cases  # noqa: E402

import repro.streaming as JS  # noqa: E402
import repro_torch.streaming as TS  # noqa: E402
from repro.core import properties as jprops  # noqa: E402
from repro_torch.core import properties as tprops  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def jax_p8(tmp_path_factory):
    ref = cases.start_reference("streaming", tmp_path_factory.mktemp("streaming") / "p8.json")
    yield ref
    ref.stop()


@pytest.fixture(scope="module")
def pkgs():
    return cases.Pkg("jax", 1), cases.Pkg("torch", 1)


@pytest.mark.parametrize("name", sorted(cases.STREAM))
def test_p1_matches_jax(name, pkgs):
    jpkg, tpkg = pkgs
    want = cases.as_json(cases.STREAM[name](jpkg, 1))
    got = cases.as_json(cases.STREAM[name](tpkg, 1))
    assert not cases.held(want), cases.held(want)
    assert got == want


@pytest.mark.parametrize("name", sorted(cases.GROUPS["streaming"]))
def test_p8_matches_jax(name, jax_p8):
    got = cases.as_json(cases.GROUPS["streaming"][name](cases.Pkg("torch", 8), 8))
    want = jax_p8()[name]
    assert not cases.held(want), cases.held(want)
    assert got == want


def test_the_reference_suites_exact_values(pkgs):
    """What tests/test_streaming.py asserts, on the port's own records."""
    t = pkgs[1]
    ex = cases.s_exhaustion(t, 1)
    rows, _ = TS.TenantRequestSource(0, seed=1, limit=50).poll(0, 50)
    assert ex["state"] == rows.astype(np.int64).sum(axis=0).tolist()
    assert ex["stats"]["committed"] == 7 and ex["stats"]["offset"] == 50
    assert ex["latency_order"] and ex["snap"][:2] == [7, 0]
    bp = cases.s_backpressure(t, 1)
    assert bp["committed"] == 10 and bp["bounded"] and bp["engaged"]
    folded = cases.s_in_order(t, 1)["folded"]
    assert folded == sorted(folded) and len(folded) == 8
    ck = cases.s_checkpoint_restart(t, 1)
    assert ck["first"] == [3, 24] and ck["restored"][0] == ck["restored"][1] >= 2
    assert ck["same"] and ck["offset"] == 48 and ck["needs_init"] == "ValueError"
    assert cases.s_skips_nothing(t, 1)["union"]


# ---------------------------------------------------------------------------
# sources: poll(offset) is a pure function of its arguments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tenant,seed", [(0, 0), (3, 11), (7, 31)])
def test_tenant_source_gives_the_references_rows(tenant, seed):
    a = TS.TenantRequestSource(tenant, seed=seed, limit=100)
    b = JS.TenantRequestSource(tenant, seed=seed, limit=100)
    for off, n in ((0, 16), (0, 7), (7, 9), (96, 16), (100, 16), (50, 1)):
        (ra, oa), (rb, ob) = a.poll(off, n), b.poll(off, n)
        assert oa == ob
        assert (ra is None and rb is None) or (ra.dtype == rb.dtype
                                               and np.array_equal(ra, rb))
    c1, o1 = a.poll(0, 7)
    c2, o2 = a.poll(o1, 9)
    assert o2 == 16 and np.array_equal(np.concatenate([c1, c2]), a.poll(0, 16)[0])


def test_array_source_bounds():
    src = TS.ArraySource(np.arange(10, dtype=np.int32))
    rows, off = src.poll(6, 8)
    assert rows.tolist() == [6, 7, 8, 9] and off == 10
    assert src.poll(10, 8) == (None, 10)


def test_iterator_source_replays_by_reconstruction_as_the_reference():
    def make(mod):
        calls = []

        def factory():
            calls.append(1)
            return (np.arange(i * 5, i * 5 + 5, dtype=np.int32).reshape(5, 1)
                    for i in range(4))

        return mod.IteratorSource(factory), calls

    (ts, tcalls), (js, jcalls) = make(TS), make(JS)
    for off, n in ((0, 7), (7, 7), (0, 7), (14, 100), (20, 4), (3, 2)):
        (ra, oa), (rb, ob) = ts.poll(off, n), js.poll(off, n)
        assert oa == ob and ((ra is None and rb is None) or np.array_equal(ra, rb))
    assert len(tcalls) == len(jcalls) == 3


def test_iterator_source_over_the_pipelines_rows_as_the_reference():
    """tests/test_streaming.py's case on the port: the data pipeline's packed
    rows are a valid stream source with deterministic replay, and the rows
    the port polls are the reference's."""
    from repro.data.pipeline import byte_tokenize as j_tok
    from repro.data.pipeline import pack_sequences as j_pack
    from repro_torch.data.pipeline import byte_tokenize, pack_sequences

    def make(mod, tok, pack):
        docs = [tok(f"document-{i}" * 3) for i in range(6)]
        return mod.IteratorSource(lambda: iter([pack([d], seq_len=8) for d in docs]))

    ts, js = make(TS, byte_tokenize, pack_sequences), make(JS, j_tok, j_pack)
    first, off = ts.poll(0, 5)
    assert first.shape[1] == 9
    again, _ = ts.poll(0, 5)
    assert (again == first).all()
    for o, n in ((0, 5), (5, 3), (0, 5), (8, 100)):
        (ra, oa), (rb, ob) = ts.poll(o, n), js.poll(o, n)
        assert oa == ob and ((ra is None and rb is None) or np.array_equal(ra, rb))


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

SCRIPT = [("try", "a"), ("try", "a"), ("try", "a"), ("try", "b"), ("try", "b"),
          ("release", "a"), ("try", "b"), ("try", "c"), ("release", "b"), ("try", "c")]


@pytest.mark.parametrize("policy,queue", [("block", 4), ("shed", 4), ("block", 0)])
def test_admission_decisions_match_the_reference(policy, queue):
    kw = dict(max_inflight=3, tenant_quota=2, queue_depth=queue, policy=policy)
    t, j = TS.AdmissionController(**kw), JS.AdmissionController(**kw)
    for op, tenant in SCRIPT:
        if op == "try":
            assert t.try_admit(tenant) == j.try_admit(tenant)
        else:
            t.release(tenant), j.release(tenant)
        assert t.inflight == j.inflight
        assert t.tenant_inflight(tenant) == j.tenant_inflight(tenant)
    with pytest.raises(ValueError):
        TS.AdmissionController(policy="bogus")


def test_admission_props_defaults_and_registry():
    c = TS.AdmissionController(tprops.IProperties())
    assert (c.max_inflight, c.tenant_quota, c.queue_depth, c.policy) == (8, 4, 16, "block")
    for k in [k for k in jprops.REGISTRY if k.startswith("ignis.stream.")]:
        a, b = jprops.REGISTRY[k], tprops.REGISTRY[k]
        assert (b.type, b.default, b.doc) == (a.type, a.default, a.doc), k


def test_stream_admit_fault_forces_a_shed():
    from repro_torch.core import faults

    c = TS.AdmissionController(max_inflight=8, tenant_quota=8, queue_depth=4)
    plan = faults.FaultPlan().fail_stream_admit(tenant="a", times=1)
    with faults.inject(plan):
        assert c.try_admit("a") == "shed"
        assert c.try_admit("a") == "admit"
    assert plan.injections("stream.admit") == 1


def test_package_exports_the_references_names():
    assert sorted(TS.__all__) == sorted(JS.__all__)
    for name in TS.__all__:
        assert hasattr(TS, name)


# ---------------------------------------------------------------------------
# one scheduler for a pump and the serve front door
# ---------------------------------------------------------------------------

def _toy_engine(slots=2):
    """Deterministic stand-in for ServeEngine: token i+1 follows token i;
    requests retire on budget."""

    class Toy:
        def __init__(self):
            self.queue = deque()
            self.live = [None] * slots
            self.retired = []

        def submit(self, req):
            self.queue.append(req)

        def step(self):
            for s in range(slots):
                if self.live[s] is None and self.queue:
                    req = self.queue.popleft()
                    req.tokens.append(int(req.prompt[-1]) + 1)
                    if len(req.tokens) >= req.max_new_tokens:
                        req.done = True
                        self.retired.append(req)
                    else:
                        self.live[s] = req
            for s, req in enumerate(self.live):
                if req is None:
                    continue
                req.tokens.append(req.tokens[-1] + 1)
                if len(req.tokens) >= req.max_new_tokens:
                    req.done = True
                    self.retired.append(req)
                    self.live[s] = None
            return sum(r is not None for r in self.live)

    return Toy()


def test_stream_and_serve_share_one_scheduler():
    import repro_torch.core as tcore
    from repro_torch.core.job import default_scheduler

    w = tcore.IWorker(tcore.ICluster(tcore.IProperties(
        {"ignis.device": "cpu", "ignis.stream.batch.rows": "8"})), "python")
    tel = TS.StreamTelemetry()
    fd = TS.ServeFrontDoor(_toy_engine(), w, telemetry=tel)
    for i in range(4):
        fd.submit(np.asarray([i], np.int32), max_new_tokens=4, tenant="serve")
    sc = TS.StreamContext(w, TS.TenantRequestSource(0, seed=4, limit=40),
                          tenant="ingest", init_state=np.zeros((2,), np.int64),
                          telemetry=tel)
    done = {}
    th = threading.Thread(target=lambda: done.update(serve=fd.run_until_drained()),
                          daemon=True)
    th.start()
    state = sc.run()
    th.join(30)
    assert not th.is_alive()
    rows, _ = TS.TenantRequestSource(0, seed=4, limit=40).poll(0, 40)
    assert state.tolist() == rows.astype(np.int64).sum(axis=0).tolist()
    assert len(done["serve"]) == 4
    snap = tel.snapshot()
    assert snap["tenants"]["serve"]["completed"] == 4
    assert snap["tenants"]["ingest"]["completed"] == 5
    assert default_scheduler().stats["tasks_completed"] > 0
