"""The port's program spans (``repro_torch.profile.spans.span``): the serve
engine, the front door's tick, the train step, the feed and the kernel
builds record ``Span``s into an attached ``JobTracer``'s buffer or, while a
``torch.profiler`` session records, into the process-wide ``PROFILED``
buffer, and nothing at all otherwise; on the CPU, at a reduced size."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import ICluster, IJob, IProperties, IWorker  # noqa: E402
from repro_torch.data.pipeline import TrainPipeline  # noqa: E402
from repro_torch.data.synthetic import synthetic_batches  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.launch.train import make_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.profile import JobTracer, spans as S, to_chrome, validate  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402
from repro_torch.streaming import ServeFrontDoor  # noqa: E402

SERVE = {"serve.tick", "engine.step", "engine.admit", "engine.prefill", "model.prefill",
         "engine.decode", "launch", "readback", "splice"}
TRAIN = {"feed.wait", "train.step", "train.forward", "train.backward", "train.optimizer"}
#: (span, its parent) as the program opens them
PARENT = {"engine.step": "serve.tick", "engine.admit": "engine.step",
          "engine.prefill": "engine.admit", "model.prefill": "launch",
          "engine.decode": "engine.step", "splice": "engine.prefill",
          "train.forward": "train.step", "train.backward": "train.step",
          "train.optimizer": "train.step"}


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("ignis-tiny")
    bundle = build_model(cfg)
    return cfg, bundle, bundle.init(torch.Generator().manual_seed(0))


@pytest.fixture
def worker():
    return IWorker(ICluster(IProperties({"ignis.device": "cpu"})), "python")


@pytest.fixture(autouse=True)
def empty_profiled():
    S.PROFILED.clear()
    yield
    S.PROFILED.clear()


def serve_loop(tiny, worker, job=None, requests=3):
    cfg, bundle, params = tiny
    fd = ServeFrontDoor(ServeEngine(bundle, params, slots=2, cache_len=32), worker, job=job)
    rng = np.random.default_rng(1)
    tix = [fd.submit(rng.integers(0, cfg.vocab_size, 5 + i, dtype=np.int32),
                     max_new_tokens=3) for i in range(requests)]
    fd.run_until_drained()
    assert all(t.done() for t in tix)
    return fd


def train_steps(tiny, steps=1):
    cfg, bundle, params = tiny
    params = build_model(cfg).init(torch.Generator().manual_seed(1))
    opt = bundle.init_opt(params)
    step = make_train_step(bundle, cfg)
    pipe = TrainPipeline(synthetic_batches(cfg.vocab_size, 2, 16, 0), device="cpu")
    try:
        for _ in range(steps):
            params, opt, _, loss = step(params, opt, None, next(pipe))
    finally:
        pipe.close()
    return float(loss)


def parent_of(span, spans):
    """The innermost span of the same thread that holds ``span``."""
    holders = [p for p in spans if p is not span and p.tid == span.tid
               and p.t0 <= span.t0 and span.t1 <= p.t1]
    return min(holders, key=lambda p: p.dur, default=None)


def check_nesting(spans):
    for s in spans:
        if s.name in PARENT:
            p = parent_of(s, spans)
            assert p is not None and p.name == PARENT[s.name], (s.name, p and p.name)
        if s.name in ("launch", "readback"):
            assert parent_of(s, spans).name in ("engine.prefill", "engine.decode")
    assert validate(to_chrome(spans)) == []


def test_off_records_nothing_and_allocates_no_span(tiny, worker):
    assert not torch.autograd.profiler._is_profiler_enabled
    sp = S.span("engine.step")
    assert not sp and sp is S.span("train.step", torch.zeros(1))
    serve_loop(tiny, worker, job=IJob("serve"))
    train_steps(tiny)
    assert len(S.PROFILED) == 0


def test_profiler_session_records_serve_spans_from_the_pool_thread(tiny, worker):
    """Ticks run on the scheduler's threads: the profiler's flag, which every
    thread sees, sends their spans to ``PROFILED``."""
    with profile(activities=[ProfilerActivity.CPU]):
        fd = serve_loop(tiny, worker)
    spans = S.PROFILED.spans()
    assert {s.name for s in spans} == SERVE
    ticks = [s for s in spans if s.name == "serve.tick"]
    assert sorted(s.args["tick"] for s in ticks) == list(range(fd.stats()["ticks"]))
    assert sum(s.args["retired"] for s in ticks) == 3
    assert all(s.args["handoff_ms"] >= 0 for s in ticks)
    assert all(s.cat == "program" for s in spans)
    check_nesting(spans)


def test_profiler_session_records_the_train_step_and_its_annotations(tiny):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss = train_steps(tiny)
    assert np.isfinite(loss)
    spans = S.PROFILED.spans()
    assert {s.name for s in spans} == TRAIN
    check_nesting(spans)
    assert all(s.device_ms is None for s in spans)  # no CUDA events on the CPU
    assert next(s for s in spans if s.name == "train.optimizer").args["leaves"] > 0
    # the spans of the profiling thread are on the profiler's own timeline
    assert TRAIN <= {e.name for e in prof.events()}


def test_attached_tracer_records_serve_spans_beside_task_spans(tiny, worker):
    job = IJob("serve")
    tracer = JobTracer().attach(job)
    try:
        fd = serve_loop(tiny, worker, job=job)
    finally:
        tracer.detach()
    spans = tracer.spans()
    program = [s for s in spans if s.cat == "program"]
    assert {s.name for s in program} == SERVE
    assert len(S.PROFILED) == 0
    check_nesting(program)
    assert validate(tracer.to_chrome()) == []
    assert len([s for s in spans if s.name.startswith("serve.tick#")]) == fd.stats()["ticks"]


def test_front_door_ticks_carry_the_jobs_tracer(tiny, worker):
    """Each ``serve.tick#n`` task span of the job's tracer holds the tick's
    ``serve.tick`` program span, on the thread that ran it."""
    job = IJob("serve")
    tracer = JobTracer().attach(job)
    try:
        serve_loop(tiny, worker, job=job)
    finally:
        tracer.detach()
    spans = tracer.spans()
    ticks = [s for s in spans if s.name == "serve.tick"]
    assert ticks
    for s in ticks:
        task = next(t for t in spans if t.name == f"serve.tick#{s.args['tick']}")
        assert task.cat == "task" and task.tid == s.tid
        assert task.t0 <= s.t0 and s.t1 <= task.t1
        # the hand-off runs from the submission, before the task's start
        assert s.args["handoff_ms"] >= 1e3 * (s.t0 - task.t0)


def test_tracer_attached_to_the_worker_records_its_tasks_spans(tiny, worker):
    tracer = JobTracer().attach_worker(worker)
    assert worker.tracer is tracer
    try:
        serve_loop(tiny, worker)
    finally:
        tracer.detach()
    assert worker.tracer is None and worker.engine.trace_hook is None
    assert {s.name for s in tracer.spans()} == SERVE


def test_attached_tracer_records_a_train_loop(tiny):
    tracer = JobTracer()
    with tracer.recording():
        train_steps(tiny, steps=2)
    spans = tracer.spans()
    assert {s.name for s in spans} == TRAIN
    assert sum(s.name == "train.step" for s in spans) == 2
    check_nesting(spans)
    assert len(S.PROFILED) == 0


def test_prefill_span_carries_request_and_queue_wait(tiny, worker):
    job = IJob("serve")
    tracer = JobTracer().attach(job)
    try:
        serve_loop(tiny, worker, job=job, requests=4)
    finally:
        tracer.detach()
    prefills = sorted((s for s in tracer.spans() if s.name == "engine.prefill"),
                      key=lambda s: s.args["rid"])
    assert [s.args["rid"] for s in prefills] == [0, 1, 2, 3]
    assert [s.args["tokens"] for s in prefills] == [5, 6, 7, 8]
    assert all(s.args["queue_ms"] >= 0 for s in prefills)
    # the two slots take requests 0 and 1 at once; 2 and 3 wait for a retirement
    assert prefills[3].args["queue_ms"] > prefills[0].args["queue_ms"]
    admits = [s for s in tracer.spans() if s.name == "engine.admit"]
    assert sum(s.args["prefills"] for s in admits) == 4


def test_engine_submit_stamps_the_request():
    from repro_torch.serving.engine import Request

    class Bundle:
        cfg = None

        @staticmethod
        def make_cache(slots, cache_len, device):
            return {}

    eng = ServeEngine(Bundle(), torch.zeros(1), slots=1, cache_len=4)
    req = Request(0, np.zeros(2, np.int32))
    assert req.t_submit == 0.0
    eng.submit(req)
    assert req.t_submit > 0.0


def test_nested_recording_restores_the_threads_buffer():
    a, b = S.TraceBuffer(), S.TraceBuffer()
    with S.recording(a):
        with S.recording(b):
            with S.span("inner"):
                pass
        with S.span("outer"):
            pass
    with S.span("after"):
        pass
    assert [s.name for s in a.spans()] == ["outer"]
    assert [s.name for s in b.spans()] == ["inner"]


def test_recording_is_per_thread():
    buf, seen = S.TraceBuffer(), []

    def other():
        with S.span("other") as sp:
            seen.append(bool(sp))

    with S.recording(buf):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert seen == [False] and len(buf) == 0


def test_profiled_buffer_keeps_its_bound_and_counts_drops():
    cap = S.PROFILED._spans.maxlen
    assert cap == 1 << 15
    for i in range(cap + 5):
        S.PROFILED.add(S.Span(f"s{i}", "program", float(i), float(i) + 0.5, 1))
    spans = S.PROFILED.spans()
    assert len(spans) == cap and S.PROFILED.dropped == 5
    assert spans[0].name == "s5" and spans[-1].name == f"s{cap + 4}"
    S.PROFILED.clear()
    assert len(S.PROFILED) == 0 and S.PROFILED.dropped == 0


def test_unbounded_buffer_drops_nothing():
    buf = S.TraceBuffer()
    for i in range(100):
        buf.record("s", "task", 0.0, 1.0)
    assert len(buf) == 100 and buf.dropped == 0


def test_between_keeps_the_spans_wholly_inside_the_interval():
    buf = S.TraceBuffer()
    for t0, t1 in ((0.0, 1.0), (1.0, 2.0), (1.5, 3.5), (3.0, 4.0)):
        buf.record(f"{t0}", "program", t0, t1)
    assert [s.name for s in buf.between(1.0, 3.0)] == ["1.0"]
    assert [s.name for s in buf.between(0.0, 4.0)] == ["0.0", "1.0", "1.5", "3.0"]
    assert buf.between(5.0, 6.0) == []


def test_device_ms_reads_the_spans_events():
    class Event:
        def __init__(self, ms):
            self.ms = ms

        def elapsed_time(self, end):
            return end.ms - self.ms

    s = S.Span("train.step", "program", 0.0, 1.0, 1, {}, (Event(2.0), Event(9.5)))
    assert s.device_ms == 7.5
    assert S.Span("x", "program", 0.0, 1.0, 1).device_ms is None
    # the events stay out of the export
    assert "events" not in str(to_chrome([s]))


def test_cpu_span_takes_no_cuda_events():
    buf = S.TraceBuffer()
    with S.recording(buf):
        with S.span("train.step", torch.zeros(1)):
            pass
    assert buf.spans()[0].events == ()


def test_kernel_build_span_replaces_the_build_log(tmp_path, monkeypatch):
    """``_cuda.load`` records ``kernel.build``: the library, the seconds, and
    whether nvcc ran (the first load) or the cached library was found."""
    assert not hasattr(_cuda, "build_logs")
    lib = tmp_path / "fake-0123.so"
    ran = []

    class Done:
        returncode = 0
        stderr = ""

    def nvcc(cmd, **kw):
        ran.append(cmd)
        open(cmd[cmd.index("-o") + 1], "w").close()
        return Done()

    monkeypatch.setattr(_cuda, "library_path", lambda name: lib)
    monkeypatch.setattr(_cuda.subprocess, "run", nvcc)
    monkeypatch.setattr(_cuda.ctypes, "CDLL", lambda path: ("lib", path))
    tracer = JobTracer()
    try:
        with tracer.recording():
            _cuda.load("fake")
            _cuda.load("fake")  # loaded: no second span
            _cuda._libs.pop("fake")
            _cuda.load("fake")  # a new process would find the library built
    finally:
        _cuda._libs.pop("fake", None)
    builds = tracer.spans()
    assert [s.name for s in builds] == ["kernel.build", "kernel.build"]
    assert [s.args["nvcc"] for s in builds] == [True, False] and len(ran) == 1
    assert all(s.args["library"] == lib.name and s.args["seconds"] >= 0 for s in builds)
