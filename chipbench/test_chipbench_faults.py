"""The comparison that decides ``correct`` fails what it must: the fp8
control (the reference one precision below the configuration's bfloat16)
and, driving the rest of a run on the CPU at a reduced size with the timed
path broken underneath, each fault a cell can have. A sound run passes and
prints the result line's keys."""
import contextlib
import json
import math

import pytest

from chipbench import calibrate, common, harness
from chipbench.conftest import tiny_cell

TRAIN = ["olmo-1b.train-8x2048", "mamba2-780m.train-4x2048"]


def run(cell, seconds=0.5):
    return harness.run_cell(cell, 2**31 + 5, seconds, False, "cpu", common.now())


@contextlib.contextmanager
def patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def unchanged_state(orig):
    def make(bundle, *a, **kw):
        def step(params, opt, ef, batch):
            loss, _ = bundle.value_and_grad(params, batch)
            return params, opt, ef, loss
        return step
    return make


def test_result_line_keys():
    res = run(tiny_cell(TRAIN[0]))
    line = json.loads(common.result_line(res["correct"], res["attempted"], res["failed"],
                                         res["metrics"], res["device"], res["checks"]))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] and line["attempted"] >= 1
    assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())


@pytest.mark.parametrize("name", TRAIN)
def test_control_fails_where_the_program_passes(name):
    cell, got = tiny_cell(name), {}
    calibrate.train_readings(cell, 7, "cpu", True, False,
                             lambda kind, seed, numbers: got.__setitem__(kind, numbers))
    worse = [k for k, lim in cell.limits.items() if got["control"][k] > lim]
    assert all(got["program"][k] <= lim for k, lim in cell.limits.items()), got["program"]
    assert worse, got["control"]


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_training_faults_fail(name, fault):
    from repro_torch.launch import train as launch_train

    cell = tiny_cell(name)
    ctx = (patched(launch_train, "make_train_step", unchanged_state)
           if fault == "unchanged_state" else calibrate.half_batch())
    with ctx:
        res = run(cell)
    assert not res["correct"], res["checks"]


def test_serve_control_fails_where_the_program_passes():
    cell, got = tiny_cell("olmo-1b.serve-chat-128"), {}
    calibrate.serve_readings(cell, 7, "cpu", True, 0.5,
                             lambda kind, seed, numbers: got.__setitem__(kind, numbers))
    assert got["program"]["max_gap"] <= cell.limits["max_gap"] < got["control"]["max_gap"]


def altered_token(orig):
    def decode(params, cache, tokens, cfg):
        logits, cache = orig(params, cache, tokens, cfg)
        return logits.roll(1, dims=-1), cache
    return decode


@pytest.mark.parametrize("fault", ["none", "altered_token", "unchanged_state"])
def test_serve_faults_fail(fault):
    from repro_torch.models import transformer
    from repro_torch.serving import engine

    cell = tiny_cell("olmo-1b.serve-chat-128")
    ctx = {"none": contextlib.nullcontext(),
           "altered_token": patched(transformer, "lm_decode_step", altered_token),
           "unchanged_state": patched(engine, "_splice",
                                      lambda orig: lambda cache, *a: cache)}[fault]
    with ctx:
        res = run(cell)  # the window closes once the mix's min_retired have retired
    assert res["correct"] == (fault == "none"), res["checks"]
    assert set(res["metrics"]) == {"serve_tokens_per_s", "ttft_p95_ms", "setup_s"}


@pytest.mark.parametrize("lost", [0, 1])
def test_only_lost_work_is_incorrect(monkeypatch, lost):
    """A request still without a token at the close is failed, and late, not
    wrong: ``correct`` reads the comparison and the work lost outright."""
    from chipbench import registry

    class Driver:
        @staticmethod
        def run(cell, seed, seconds, trace, device, out):
            out.metrics.update(serve_tokens_per_s=1.0, ttft_p95_ms=math.inf, setup_s=1.0)
            out.attempted, out.failed, out.lost = 10, 3, lost
            out.numbers = {"length_mismatch": 0.0, "max_gap": 0.0}

    monkeypatch.setattr(registry, "driver", lambda kind: Driver)
    res = run(tiny_cell("olmo-1b.serve-chat-128"))
    assert res["failed"] == 3 and res["correct"] == (lost == 0)
