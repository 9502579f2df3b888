"""The port's profile package (``repro_torch.profile``) against the JAX
package's (``repro.profile``): the trace schema, the tracer, replay and
calibration on the CPU.

The schema, tracer and replay cases of tests/test_profile.py run on both
packages (parametrised by ``pkg``); the cross-package cases hold the port
to the reference on the same inputs: ``validate()`` verdicts, span names,
categories and arg keys of the same job, ``summary()`` and cost-snapshot
keys, and replay schedules, all exactly. At p = 8 the reference runs in a
subprocess (tests/_torch_profile_main.py over tests/_torch_profile_cases.py)
and the capture of the same two-gang job must have the same task kinds,
lanes and dependencies."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_profile_cases as cases  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro.profile as jprof  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.profile as tprof  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
PKGS = {"repro": (jcore, jprof, {}),
        "repro_torch": (tcore, tprof, {"ignis.device": "cpu"})}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _worker(pkg, **props):
    core, _prof, base = pkg
    return core.IWorker(core.ICluster(core.IProperties({**base, **props})), "python")


def _traced_run(pkg, worker, n_actions=3):
    """Run a few actions under an attached tracer; return (job, tracer)."""
    core, prof, _ = pkg
    tracer = prof.JobTracer()
    tracer.attach_worker(worker)
    job = core.IJob("traced")
    tracer.attach(job)
    df = worker.parallelize(np.arange(64, dtype=np.int32)).map(lambda x: x + 1)
    futs = [df.count_async(job=job) for _ in range(n_actions)]
    for f in futs:
        assert f.result() == 64
    return job, tracer


# ---------------------------------------------------------------------------
# tests/test_profile.py's schema, tracer and replay cases, on both packages
# ---------------------------------------------------------------------------


def test_chrome_trace_validates_clean(pkg, tmp_path):
    prof = pkg[1]
    job, tracer = _traced_run(pkg, _worker(pkg))
    trace = tracer.to_chrome()
    assert prof.validate(trace) == []
    task_events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    assert task_events
    assert all("lane" in e["args"] for e in task_events
               if e.get("cat") in ("task", "sched"))
    path = tmp_path / "trace.json"
    tracer.save(str(path))
    assert prof.validate(json.loads(path.read_text())) == []
    tracer.detach()


def test_validate_flags_negative_duration(pkg):
    prof = pkg[1]
    bad = prof.to_chrome([prof.Span("t", "task", 2.0, 1.0, 1, {"lane": "w"})])
    bad["traceEvents"][-1]["dur"] = -5.0
    assert any("negative dur" in p for p in prof.validate(bad))


def test_validate_flags_non_nesting_overlap(pkg):
    prof = pkg[1]
    spans = [prof.Span("a", "task", 0.0, 1.0, 7, {}),
             prof.Span("b", "task", 0.5, 1.5, 7, {})]
    assert any("overlaps" in p for p in prof.validate(prof.to_chrome(spans)))
    ok = [prof.Span("a", "task", 0.0, 1.0, 7, {}),
          prof.Span("b", "task", 0.5, 1.5, 8, {})]
    assert prof.validate(prof.to_chrome(ok)) == []


def test_validate_rejects_malformed_container(pkg):
    assert pkg[1].validate({}) == ["traceEvents missing or not a list"]


def test_trace_lanes_match_explain_groups(pkg):
    core, prof, _ = pkg
    w = _worker(pkg)
    g = w.groups(1)[0]
    tracer = prof.JobTracer()
    job = core.IJob("gang", group=g)
    tracer.attach(job)
    df = w.parallelize(np.arange(32, dtype=np.int32))
    assert df.count_async(job=job).result() == 32
    lanes = {s.args.get("lane") for s in tracer.spans() if s.cat == "task"}
    assert g.label() in lanes


def test_tracer_summary_and_profile_mount(pkg):
    w = _worker(pkg)
    job, tracer = _traced_run(pkg, w)
    summ = tracer.summary()
    assert summ["tasks"] >= 3
    assert summ["makespan_ms"] > 0
    assert summ["cost"]["tasks_observed"] >= 3
    assert w.metrics("profile")["tasks"] == summ["tasks"]
    assert job.metrics("profile")["tasks"] == summ["tasks"]
    tracer.detach()


def _diamond(prof):
    return prof.Trace(tasks=(
        prof.TaskRecord(0, "a", "stage", "w0", 1.0),
        prof.TaskRecord(1, "b", "stage", "w0", 2.0, deps=(0,)),
        prof.TaskRecord(2, "c", "stage", "w1", 3.0, deps=(0,)),
        prof.TaskRecord(3, "d", "action", "w0", 1.0, deps=(1, 2)),
    ), wall_s=5.0)


def test_replay_is_deterministic(pkg):
    prof = pkg[1]
    s1 = prof.simulate(_diamond(prof), prof.Hypothesis(lanes=2))
    s2 = prof.simulate(_diamond(prof), prof.Hypothesis(lanes=2))
    assert s1 == s2
    assert s1.order == s2.order and s1.task_times == s2.task_times


def test_replay_diamond_semantics(pkg):
    s = pkg[1].simulate(_diamond(pkg[1]))
    assert s.makespan_s == pytest.approx(1.0 + 3.0 + 1.0)
    assert s.task_times[3][0] == pytest.approx(4.0)
    assert s.order == (0, 1, 2, 3)


def test_replay_single_lane_serialises(pkg):
    prof = pkg[1]
    s = prof.simulate(_diamond(prof), prof.Hypothesis(lanes=1))
    assert s.makespan_s == pytest.approx(1.0 + 2.0 + 3.0 + 1.0)
    assert s.lanes == ("lane0",)


def test_replay_settle_frees_lane_but_blocks_dependents(pkg):
    prof = pkg[1]
    tr = prof.Trace(tasks=(
        prof.TaskRecord(0, "a", "stage", "w0", 1.0, settle_s=2.0),
        prof.TaskRecord(1, "b", "stage", "w0", 1.0),
        prof.TaskRecord(2, "c", "stage", "w1", 0.5, deps=(0,)),
    ))
    s = prof.simulate(tr)
    assert s.task_times[1][0] == pytest.approx(1.0)
    assert s.task_times[2][0] == pytest.approx(3.0)


def _straggler(prof):
    return prof.Trace(tasks=(
        prof.TaskRecord(0, "a", "stage", "w0", 1.0),
        prof.TaskRecord(1, "b", "stage", "w1", 50.0),
        prof.TaskRecord(2, "c", "stage", "w0", 1.0),
    ))


def test_replay_speculative_timeout_caps_straggler(pkg):
    prof = pkg[1]
    base = prof.simulate(_straggler(prof)).makespan_s
    cut = prof.simulate(_straggler(prof), prof.Hypothesis(speculative_timeout_s=2.0)).makespan_s
    assert base == pytest.approx(50.0)
    assert cut == pytest.approx(3.0)


def test_replay_scale_and_price_override(pkg):
    prof = pkg[1]
    tr = _diamond(prof)
    assert prof.simulate(tr, prof.Hypothesis(scale=2.0)).makespan_s == pytest.approx(
        2 * prof.simulate(tr).makespan_s)
    assert prof.simulate(tr, price=lambda t: 1.0).makespan_s == pytest.approx(3.0)


def _cycle(prof):
    return prof.Trace(tasks=(
        prof.TaskRecord(0, "a", "stage", "w0", 1.0, deps=(1,)),
        prof.TaskRecord(1, "b", "stage", "w0", 1.0, deps=(0,)),
    ))


def test_replay_cycle_raises(pkg):
    with pytest.raises(ValueError, match="cycle"):
        pkg[1].simulate(_cycle(pkg[1]))


def test_capture_and_identity_replay_accuracy(pkg):
    prof = pkg[1]
    job, tracer = _traced_run(pkg, _worker(pkg), n_actions=4)
    tr = prof.capture(job)
    assert len(tr.tasks) >= 4 and tr.wall_s > 0
    r = prof.predicted_vs_measured(job)
    assert r["tasks"] == len(tr.tasks)
    assert 0.0 < r["accuracy"] <= 1.0
    tracer.detach()


def test_shared_cost_model_observes_each_task_once(pkg):
    """With the tracer adopting the engine's model (``attach_worker``), the
    scheduler does not observe a task a second time (core/job.py
    ``_observe``): the history grows by exactly the finished tasks."""
    w = _worker(pkg)
    before = w.engine.cost_model.snapshot()["tasks_observed"]
    job, tracer = _traced_run(pkg, w, n_actions=3)
    assert tracer.cost is w.engine.cost_model
    done = sum(1 for t in job.tasks if t.state == "done")
    assert w.engine.cost_model.snapshot()["tasks_observed"] - before == done == 3
    tracer.detach()


# ---------------------------------------------------------------------------
# the port against the reference on the same inputs
# ---------------------------------------------------------------------------

SPAN_LISTS = {
    "empty": [],
    "nested": [("a", "task", 0.0, 2.0, 1, {"lane": "w"}), ("b", "task", 0.5, 1.5, 1, {})],
    "overlap": [("a", "task", 0.0, 1.0, 7, {}), ("b", "task", 0.5, 1.5, 7, {})],
    "two_threads": [("a", "task", 0.0, 1.0, 7, {}), ("b", "sched", 0.5, 1.5, 8, {"lane": "g"})],
    "touching": [("a", "task", 0.0, 1.0, 3, {}), ("b", "task", 1.0, 2.0, 3, {}),
                 ("c", "engine", 1.2, 1.8, 3, {"op": "x"})],
}


@pytest.mark.parametrize("name", sorted(SPAN_LISTS))
def test_chrome_export_and_validate_verdicts_equal(name):
    spans = SPAN_LISTS[name]
    jt = jprof.to_chrome([jprof.Span(*s) for s in spans], "p")
    tt = tprof.to_chrome([tprof.Span(*s) for s in spans], "p")
    assert tt == jt
    assert tprof.validate(tt) == jprof.validate(jt)
    if jt["traceEvents"]:
        for trace in (jt, tt):
            trace["traceEvents"][-1]["dur"] = -1.0
        assert tprof.validate(tt) == jprof.validate(jt) != []
    assert tprof.validate({"traceEvents": 3}) == jprof.validate({"traceEvents": 3})


def _span_shape(tracer):
    return sorted({(s.name if s.cat != "task" or s.name in ("compute", "settle")
                    else "<task>", s.cat, tuple(sorted(s.args))) for s in tracer.spans()})


def test_spans_of_the_same_p1_job_match_the_reference():
    shapes, summaries = {}, {}
    for name, pkg in PKGS.items():
        w = _worker(pkg)
        job, tracer = _traced_run(pkg, w)
        df = w.parallelize({"key": np.arange(64, dtype=np.int32) % 5,
                            "value": np.ones(64, dtype=np.int32)})
        assert df.reduce_by_key(lambda a, b: a + b, 0).count_async(job=job).result() == 5
        shapes[name] = {s for s in _span_shape(tracer) if s[0] not in ("lock_wait", "settle")}
        summaries[name] = tracer.summary()
        tracer.detach()
    assert shapes["repro_torch"] == shapes["repro"]
    assert {s[0] for s in shapes["repro"]} >= {"<task>", "compute", "wide:reduceByKey"}
    assert summaries["repro_torch"].keys() == summaries["repro"].keys()
    assert summaries["repro_torch"]["cost"].keys() == summaries["repro"]["cost"].keys()
    for k in ("spans", "tasks", "engine_spans"):
        assert summaries["repro_torch"][k] == summaries["repro"][k], k


HYPOTHESES = {
    "identity": dict(),
    "lanes1": dict(hypothesis=dict(lanes=1)),
    "lanes2": dict(hypothesis=dict(lanes=2)),
    "scale": dict(hypothesis=dict(scale=2.5)),
    "placement": dict(hypothesis=dict(placement={"w1": "w0"})),
    "price": dict(price=lambda t: 0.25 * (t.id + 1)),
    "speculative": dict(hypothesis=dict(speculative_timeout_s=2.0)),
}


@pytest.mark.parametrize("trace", ["diamond", "straggler"])
@pytest.mark.parametrize("hyp", sorted(HYPOTHESES))
def test_simulate_gives_the_reference_schedule(trace, hyp):
    spec = HYPOTHESES[hyp]
    make = {"diamond": _diamond, "straggler": _straggler}[trace]
    got, want = ((prof.simulate(make(prof),
                                prof.Hypothesis(**spec["hypothesis"]) if "hypothesis" in spec
                                else None, price=spec.get("price")))
                 for prof in (tprof, jprof))
    assert (got.makespan_s, got.task_times, got.order, got.lanes) == (
        want.makespan_s, want.task_times, want.order, want.lanes)
    assert got.explain() == want.explain()


def test_simulate_raises_on_a_cycle_in_both_packages():
    errors = []
    for prof in (tprof, jprof):
        with pytest.raises(ValueError, match="cycle") as e:
            prof.simulate(_cycle(prof))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_captured_trace_replays_identically_in_both_packages():
    """The port's capture of a real job, carried into the reference's
    records, gives the identical schedule under every hypothesis."""
    pkg = PKGS["repro_torch"]
    job, tracer = _traced_run(pkg, _worker(pkg), n_actions=4)
    tr = tprof.capture(job)
    jtr = jprof.Trace(tasks=tuple(jprof.TaskRecord(**vars(t)) for t in tr.tasks),
                      wall_s=tr.wall_s)
    for spec in (None, tprof.Hypothesis(lanes=1)):
        got = tprof.simulate(tr, spec)
        want = jprof.simulate(jtr, None if spec is None else jprof.Hypothesis(lanes=1))
        assert (got.makespan_s, got.task_times, got.order) == (
            want.makespan_s, want.task_times, want.order)
    tracer.detach()


@pytest.fixture(scope="module")
def jax_p8(tmp_path_factory):
    out = tmp_path_factory.mktemp("profile") / "jax_p8.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, os.path.join(HERE, "_torch_profile_main.py"),
                        str(out)], env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "TORCH_PROFILE_JAX_OK" in r.stdout, r.stderr[-3000:]
    return json.loads(out.read_text())


def test_two_gang_capture_at_p8_matches_the_reference(jax_p8):
    got = cases.two_gang_job(tcore, tprof, {"ignis.executor.instances": "8",
                                            "ignis.device": "cpu"})
    want = jax_p8["gang"]
    assert got["counts"] == want["counts"] == [64, 7, 64]
    assert got["tasks"] == want["tasks"]
    assert got["lanes"] == want["lanes"] == ["data[0:4]", "data[4:8]"]
    shape = lambda spans: {tuple(s[:2]): tuple(s[2]) for s in spans}  # noqa: E731
    g, w = shape(got["spans"]), shape(want["spans"])
    for key in set(g) & set(w):
        assert g[key] == w[key], key
    assert {("<task>", "task"), ("compute", "task")} <= set(g) & set(w)


def test_exports_cover_the_reference():
    names = [n for n in dir(jprof) if not n.startswith("_")
             and n not in ("cost", "replay", "spans", "tracer", "calibration")]
    assert names and all(hasattr(tprof, n) for n in names), names
    for n in ("calibrate", "calibrated_model", "fit_from_trace", "save_chrome"):
        assert hasattr(tprof, n)


def test_calibrate_gives_positive_params_on_the_cpu():
    p = tprof.calibrate(n=64, device="cpu")
    assert p.flops_per_s > 0 and p.hbm_bytes_per_s > 0 and p.dispatch_s > 0
    d = tprof.DeviceParams()
    assert (p.wire_bytes_per_s, p.compile_s_per_op) == (d.wire_bytes_per_s, d.compile_s_per_op)
    m = tprof.calibrated_model(n=64, device="cpu")
    assert m.params.flops_per_s > 0
    assert tprof.fit_from_trace(m, [(1.0, 3.0)]) == pytest.approx(3.0)


# ---------------------------------------------------------------------------
# tests/test_profile.py's two cost-model decisions, on both packages
# ---------------------------------------------------------------------------


def test_cost_fusion_defers_then_fuses(pkg):
    f1, f2 = (lambda x: x * 2), (lambda x: x + 1)
    w = _worker(pkg, **{"ignis.fusion.mode": "cost"})
    assert w.engine.fusion_mode == "cost" and w.engine.cost_model is not None

    def build():
        return w.parallelize(np.arange(64, dtype=np.int32)).map(f1).map(f2)

    assert build().count() == 64  # first sighting: the build is unamortised
    assert w.engine.stats["fusion_deferred"] == 1
    assert w.engine.stats["fused_stages"] == 0
    assert build().count() == 64  # second sighting: amortised, fuse
    assert w.engine.stats["fused_stages"] == 1
    cost = w.engine.cost_model.snapshot()
    assert cost["fuse_decisions"] >= 2 and cost["fuse_deferrals"] >= 1


def test_explain_does_not_consume_sightings(pkg):
    w = _worker(pkg, **{"ignis.fusion.mode": "cost"})
    df = w.parallelize(np.arange(32, dtype=np.int32)).map(lambda x: x * 2).map(lambda x: x - 3)
    before = w.engine.cost_model.snapshot()["stage_signatures"]
    w.engine.explain(df.node)
    assert w.engine.cost_model.snapshot()["stage_signatures"] == before


def test_should_fuse_first_sighting_math(pkg):
    m = pkg[1].CostModel()
    p = m.params
    big = int(2 * p.compile_s_per_op / p.dispatch_s) + 1
    assert m.should_fuse("sigA", n_ops=2, nblocks=big) is True
    assert m.should_fuse("sigB", n_ops=2, nblocks=1) is False
    assert m.should_fuse("sigB", n_ops=2, nblocks=1) is True
    assert m.peek_fuse("sigC") is False
    assert m.should_fuse("sigC", n_ops=3, nblocks=1) is False


def test_static_mode_fuses_unconditionally(pkg):
    w = _worker(pkg)
    df = w.parallelize(np.arange(32, dtype=np.int32))
    assert df.map(lambda x: x * 2).map(lambda x: x + 1).count() == 32
    assert w.engine.stats["fusion_deferred"] == 0
    assert w.engine.stats["fused_stages"] >= 1


def test_auto_timeout_derives_from_history(pkg):
    m = pkg[1].CostModel()
    key = ("stage", "sig")
    assert m.speculative_timeout_s(key, default_s=30.0) == 30.0
    for d in (1.0, 2.0, 9.0):
        m.observe_task(key, d)
    assert m.typical_s(key) == 2.0
    assert m.speculative_timeout_s(key, factor=3.0) == pytest.approx(6.0)
    m.observe_task(("stage", "fast"), 1e-5)
    assert m.speculative_timeout_s(("stage", "fast"), factor=3.0) == pytest.approx(0.05)


def test_auto_timeout_used_by_gang_scheduler(pkg):
    core = pkg[0]
    w = _worker(pkg, **{"ignis.task.speculative": "true",
                        "ignis.task.speculative.timeout": "auto"})
    g = w.groups(1)[0]
    before = w.engine.cost_model.snapshot()["auto_timeouts"]
    job = core.IJob("auto", group=g)
    assert w.parallelize(np.arange(16, dtype=np.int32)).count_async(job=job).result() == 16
    assert w.engine.cost_model.snapshot()["auto_timeouts"] > before


def test_cost_decisions_equal_the_reference():
    """The same sequence of sightings and observations gives the same
    decisions, deadlines and snapshot in both packages."""
    models = [jprof.CostModel(), tprof.CostModel()]
    got = []
    for m in models:
        out = [m.should_fuse(sig, n_ops=n, nblocks=b)
               for sig, n, b in (("a", 2, 1), ("a", 2, 1), ("b", 3, 500), ("c", 4, 1))]
        for d in (0.5, 0.1, 0.2, 3.0):
            m.observe_task(("stage", "x"), d)
        out.append(m.speculative_timeout_s(("stage", "x")))
        out.append(m.speculative_timeout_s(("stage", "none")))
        out.append(m.snapshot())
        got.append(out)
    assert got[0] == got[1]
