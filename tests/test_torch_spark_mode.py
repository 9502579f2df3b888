"""``ignis.mode=spark`` in the port: the driver-pipe baseline the paper
measures (every result device → host → per-element pickle → device).
Twins of tests/test_system.py::test_spark_mode_parity,
tests/test_fusion.py::test_spark_mode_pipe_disables_fusion and
tests/test_shuffle_engine.py::test_spark_mode_shuffle_parity, each held
against the JAX package, plus ``import_data`` across a spark worker and
the pipe's own accounting (per-row pickles in batches of 1024; never
reached in ignis mode). Integers compare bit for bit; f32 sums within
1e-6 relative (the pipe does not touch the values, so they agree exactly
here)."""
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import cluster as tcluster  # noqa: E402

CPU = {"ignis.device": "cpu"}


def tworker(mode="ignis", **props):
    return tcore.IWorker(tcore.ICluster(tcore.IProperties(
        {**CPU, "ignis.mode": mode, **props})), "python")


def jworker(mode="ignis", **props):
    return jcore.IWorker(jcore.ICluster(jcore.IProperties(
        {"ignis.mode": mode, **props})), "python")


@pytest.fixture
def pipe_calls(monkeypatch):
    """Count the blocks that pay the pipe, the pickled batches of rows, and
    the blocks pickled whole (import_data's pipe)."""
    calls = {"blocks": 0, "batches": 0, "rows": 0, "whole": 0}
    block = tcore.IWorker._pipe_block

    def counted_block(self, b):
        calls["blocks"] += 1
        return block(self, b)

    def counted_dumps(obj, *a, **kw):
        if isinstance(obj, list) and obj and isinstance(obj[0], list):
            calls["batches"] += 1
            calls["rows"] += len(obj)
        else:
            calls["whole"] += 1
        return pickle.dumps(obj, *a, **kw)

    class _Pickle:
        dumps = staticmethod(counted_dumps)
        loads = staticmethod(pickle.loads)

    monkeypatch.setattr(tcore.IWorker, "_pipe_block", counted_block)
    monkeypatch.setattr(tcluster, "pickle", _Pickle)
    return calls


def _kv_sums(w):
    data = np.arange(50, dtype=np.int32)
    kv = w.parallelize(data).map(lambda x: {"key": x % 5, "value": x})
    return {int(np.asarray(r["key"])): int(np.asarray(r["value"]))
            for r in kv.reduce_by_key(lambda a, b: a + b).collect()}


@pytest.mark.parametrize("p", ["1", "8"])
def test_spark_mode_parity(p, pipe_calls):
    """spark mode must be numerically identical — only slower (the pipe)."""
    want = {k: sum(x for x in range(50) if x % 5 == k) for k in range(5)}
    assert _kv_sums(jworker("spark")) == want
    assert _kv_sums(tworker(**{"ignis.executor.instances": p})) == want
    assert pipe_calls["blocks"] == 0  # ignis mode never reaches the pipe
    assert _kv_sums(tworker("spark", **{"ignis.executor.instances": p})) == want
    assert pipe_calls["blocks"] >= 2  # the map and the reduceByKey paid it


def test_spark_mode_float_reduce_matches_ignis():
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 17, 300).astype(np.int32)
    vals = rng.normal(size=300).astype(np.float32)
    outs = []
    for w in (tworker(), tworker("spark"), jworker("spark")):
        rows = w.parallelize({"key": keys, "value": vals}).reduce_by_key(
            lambda a, b: a + b, 0.0).collect()
        outs.append(sorted((int(r["key"]), float(r["value"])) for r in rows))
    for got in outs[1:]:
        assert [k for k, _v in got] == [k for k, _v in outs[0]]
        np.testing.assert_allclose([v for _k, v in got], [v for _k, v in outs[0]],
                                   rtol=1e-6, atol=1e-6)


def _chain(df):
    return df.map(lambda x: x * 2).filter(lambda x: x % 3 == 0).map(lambda x: x + 1)


def test_spark_mode_pipe_disables_fusion(pipe_calls):
    want = sorted(2 * x + 1 for x in range(30) if (2 * x) % 3 == 0)
    js = jworker("spark")
    jdf = _chain(js.parallelize(np.arange(30, dtype=np.int32)))
    assert js.engine.plan(jdf.node) == {}
    ws = tworker("spark")
    df = _chain(ws.parallelize(np.arange(30, dtype=np.int32)))
    assert ws.engine.plan(df.node) == {}
    assert sorted(int(x) for x in df.collect()) == want
    assert pipe_calls["blocks"] == 3  # each narrow op paid the pipe on its own
    # the same chain in ignis mode fuses, as in the reference
    wi = tworker()
    dfi = _chain(wi.parallelize(np.arange(30, dtype=np.int32)))
    assert [n.op for n in wi.engine.plan(dfi.node)[dfi.node].nodes] == ["map", "filter", "map"]
    assert sorted(int(x) for x in dfi.collect()) == want


def test_spark_mode_shuffle_parity(pipe_calls):
    """The manager runs identically under the spark pipe — only slower."""
    data = np.random.default_rng(3).integers(0, 99, 40).astype(np.int32)
    outs = [[int(x) for x in w.parallelize(data).sort().collect()]
            for w in (tworker(), tworker("spark"), jworker("spark"))]
    assert outs[0] == outs[1] == outs[2] == sorted(int(v) for v in data)
    # the sort (the one op after the source) pickled every row, in one batch
    assert pipe_calls["blocks"] == 1
    assert pipe_calls["rows"] == 40 and pipe_calls["batches"] == 1


def test_pipe_pickles_valid_rows_in_batches_of_1024(pipe_calls):
    w = tworker("spark", **{"ignis.executor.instances": "8"})
    n = 2500
    df = w.parallelize(np.arange(n, dtype=np.int32)).filter(lambda x: x % 5 != 0)
    assert df.count() == n - n // 5
    # parallelize is a source (no pipe); the filter's block pays it once
    assert pipe_calls["blocks"] == 1
    assert pipe_calls["rows"] == n - n // 5 and pipe_calls["batches"] == 2
    assert tcore.IWorker._PIPE_BATCH == jcore.IWorker._PIPE_BATCH == 1024


@pytest.mark.parametrize("src_mode,dst_mode", [("spark", "ignis"), ("ignis", "spark"),
                                               ("ignis", "ignis")])
def test_import_data_across_a_spark_worker(src_mode, dst_mode, pipe_calls):
    """import_data serializes through the host when either side runs spark;
    the rows are those of the reference's import."""
    data = {"key": np.arange(24, dtype=np.int32) % 7,
            "value": np.linspace(0, 1, 24, dtype=np.float32)}
    outs = []
    for make in (tworker, jworker):
        src = make(src_mode)
        dst = type(src)(make(dst_mode).cluster, "cpp")
        df = src.parallelize(data).map(lambda r: {"key": r["key"] * 3, "value": r["value"]})
        rows = dst.import_data(df).collect()
        outs.append(sorted((int(r["key"]), float(r["value"])) for r in rows))
    assert outs[0] == outs[1]
    assert [k for k, _v in outs[0]] == sorted(3 * (i % 7) for i in range(24))
    assert (pipe_calls["blocks"] > 0) == (src_mode == "spark")  # map on a spark worker
    assert pipe_calls["whole"] == (1 if "spark" in (src_mode, dst_mode) else 0)
