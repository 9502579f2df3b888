"""The per-layer readers of the program's own spans (``queue_wait_ms``,
``prefill_host_share``, ``decode_host_share``, ``tick_gap_ms`` of the
serve cell; ``backward_share``, ``optimizer_share`` of the train cell):
each reads the spans that the port's recorder kept in the traced window,
and nothing where it finds none."""
from types import SimpleNamespace

import pytest

from chipbench import common, harness, registry
from chipbench.conftest import tiny_cell

SERVE = ["queue_wait_ms.serve", "prefill_host_share.serve", "decode_host_share.serve",
         "tick_gap_ms.serve"]
TRAIN = ["backward_share.train", "optimizer_share.train"]


@pytest.fixture
def profiled():
    from repro_torch.profile import spans as S

    S.PROFILED.clear()
    yield S
    S.PROFILED.clear()


def traced(t0=0.0, window_s=100.0):
    return SimpleNamespace(trace=SimpleNamespace(_t0=t0, window_s=window_s, busy_s=1.0))


class Event:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


def add(S, name, t0, t1, tid=1, events=(), **args):
    S.PROFILED.add(S.Span(name, "program", t0, t1, tid, args, events))


def serve_spans(S, tid=1):
    """Two ticks: the first admits two prefills, each 3 s of launch (1 s of
    it inside the model) and 1 s of readback; both ticks decode with 1 s of
    launch and 4 s of readback."""
    add(S, "serve.tick", 10.0, 30.0, tid, tick=0, retired=0, handoff_ms=0.5)
    add(S, "engine.step", 10.0, 29.0, tid)
    add(S, "engine.admit", 10.0, 20.0, tid, prefills=2)
    for start, rid, wait in ((10.0, 0, 2.0), (15.0, 1, 6.0)):
        add(S, "engine.prefill", start, start + 4.5, tid, rid=rid, tokens=8, queue_ms=wait)
        add(S, "launch", start, start + 3.0, tid)
        add(S, "model.prefill", start + 0.5, start + 1.5, tid)
        add(S, "readback", start + 3.0, start + 4.0, tid)
        add(S, "splice", start + 4.0, start + 4.5, tid)
    for start in (20.0, 40.0):
        add(S, "engine.decode", start, start + 5.0, tid, live=2)
        add(S, "launch", start, start + 1.0, tid)
        add(S, "readback", start + 1.0, start + 5.0, tid)
    add(S, "serve.tick", 32.5, 46.0, tid, tick=1, retired=1, handoff_ms=1.5)


def test_serve_readers_on_synthetic_spans(profiled):
    serve_spans(profiled)
    run = traced()
    read = {m: registry.metric_reader(m)(run) for m in SERVE}
    assert read["queue_wait_ms.serve"] == pytest.approx(4.0)
    # host: 1.5 s a prefill (launch start to model.prefill end); whole 4 s
    assert read["prefill_host_share.serve"] == pytest.approx(100 * 3.0 / 8.0)
    assert read["decode_host_share.serve"] == pytest.approx(100 * 2.0 / 10.0)
    assert read["tick_gap_ms.serve"] == pytest.approx(1.0)


def test_readers_keep_to_the_traced_window(profiled):
    serve_spans(profiled)
    add(profiled, "engine.prefill", 200.0, 201.0, rid=9, tokens=8, queue_ms=1000.0)
    add(profiled, "serve.tick", 205.0, 206.0, tick=2, retired=0, handoff_ms=1000.0)
    run = traced(0.0, 100.0)
    assert registry.metric_reader("queue_wait_ms.serve")(run) == pytest.approx(4.0)
    assert registry.metric_reader("tick_gap_ms.serve")(run) == pytest.approx(1.0)


def test_host_share_counts_children_of_their_own_parent_only(profiled):
    serve_spans(profiled, tid=1)
    # a launch on another thread, inside a prefill's interval, is not its child
    add(profiled, "launch", 11.0, 11.5, tid=2)
    run = traced()
    assert registry.metric_reader("prefill_host_share.serve")(run) == pytest.approx(37.5)


def test_train_readers_on_synthetic_spans(profiled):
    for i in range(2):
        b = 100.0 * i
        add(profiled, "train.step", b, b + 10.0, events=(Event(b), Event(b + 50.0)))
        add(profiled, "train.forward", b, b + 2.0, events=(Event(b), Event(b + 10.0)))
        add(profiled, "train.backward", b + 2.0, b + 8.0,
            events=(Event(b + 10.0), Event(b + 45.0)))
        add(profiled, "train.optimizer", b + 8.0, b + 9.0,
            events=(Event(b + 45.0), Event(b + 48.0)))
    run = traced(0.0, 1000.0)
    assert registry.metric_reader("backward_share.train")(run) == pytest.approx(70.0)
    assert registry.metric_reader("optimizer_share.train")(run) == pytest.approx(6.0)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_reader_reads_nothing_without_spans(profiled, name):
    read = registry.metric_reader(name)
    assert read(traced()) is None  # a window in which nothing was recorded
    serve_spans(profiled)
    assert read(SimpleNamespace(trace=None)) is None  # no traced window


def test_train_readers_need_device_events(profiled):
    add(profiled, "train.step", 0.0, 1.0)
    add(profiled, "train.backward", 0.2, 0.8)
    for name in TRAIN:
        assert registry.metric_reader(name)(traced()) is None


def test_serve_readers_on_spans_recorded_under_a_profiler(profiled):
    """A reduced serve window through the front door, recorded under a CPU
    profiler session, read as a traced window."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core import ICluster, IProperties, IWorker
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    from repro_torch.streaming import ServeFrontDoor

    cfg = get_config("ignis-tiny")
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(0))
    worker = IWorker(ICluster(IProperties({"ignis.device": "cpu"})), "python")
    fd = ServeFrontDoor(ServeEngine(bundle, params, slots=2, cache_len=32), worker)
    for i in range(4):
        fd.submit(np.arange(4 + i, dtype=np.int32), max_new_tokens=3)
    t0 = common.now()
    with profile(activities=[ProfilerActivity.CPU]):
        fd.run_until_drained()
    run = traced(t0, common.now() - t0)
    read = {m: registry.metric_reader(m)(run) for m in SERVE}
    assert read["queue_wait_ms.serve"] > 0 and read["tick_gap_ms.serve"] >= 0
    assert 0 < read["prefill_host_share.serve"] <= 100
    assert 0 < read["decode_host_share.serve"] <= 100


def test_cpu_runs_read_none_of_them():
    """On the CPU the benchmark traces no window, so the readers return
    nothing, whatever the recorder holds."""
    res = harness.run_cell(tiny_cell("olmo-1b.serve-chat-128"), 2**31 + 9, 0.5, True, "cpu",
                           common.now())
    assert res["correct"]
    assert not set(res["metrics"]) & set(SERVE + TRAIN)
    assert {"tick_ms.serve", "prefill_ms.serve"} <= set(res["metrics"])
