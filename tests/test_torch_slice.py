"""The torch port's first slice as a whole, held against the JAX package.

Every scenario of tests/_torch_parity_cases.py — the quickstart wordcount
with its native call, map → filter → reduceByKey (add / max / min / a
non-builtin fn), sort, sort_by descending, distinct, groupByKey,
partitionBy, join, and a two-branch IJob of async futures — runs under
``ignis.kernels`` off and interpret, each action twice, on both packages.
Collected rows must be equal, and so must the shuffle, kernel and stage
counters. At p=1 the JAX package runs in this process; at p=8 it runs in a
subprocess (tests/_torch_parity_main.py, 8 fake XLA host devices) started by
the first test of this module, so it overlaps the p=1 cases.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.interop import block_from_reference, block_to_numpy  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_parity_cases as cases  # noqa: E402

CPU = {"ignis.device": "cpu"}
MODES = ("off", "interpret")
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module", autouse=True)
def jax_p8(tmp_path_factory):
    """Start the JAX p=8 subprocess once for the module; tests that need it
    call ``.result()``, which waits for it."""
    out = tmp_path_factory.mktemp("parity") / "jax_p8.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_parity_main.py"), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    class Handle:
        _data = None

        def result(self):
            if self._data is None:
                so, se = proc.communicate(timeout=600)
                assert proc.returncode == 0, f"stdout:\n{so}\nstderr:\n{se[-3000:]}"
                assert "TORCH_PARITY_JAX_OK" in so
                z = np.load(out)
                Handle._data = (json.loads(str(z["results"])),
                                {k: z[k] for k in z.files if k != "results"})
            return self._data

    h = Handle()
    yield h
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ops():
    return cases.jax_ops(), cases.torch_ops()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(cases.CASES))
def test_p1_matches_jax(name, mode, ops):
    jops, tops = ops
    ref = cases.run_case(name, jcore, jops, mode, 1)
    got = cases.run_case(name, tcore, tops, mode, 1, CPU)
    assert got["rows"] == ref["rows"]
    assert got["counters"] == ref["counters"], cases.COUNTERS
    assert got["stages"] == ref["stages"], cases.STAGE_COUNTERS


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(cases.CASES))
def test_p8_matches_jax(name, mode, ops, jax_p8):
    results, _ = jax_p8.result()
    ref = results[f"{name}|{mode}"]
    got = cases.run_case(name, tcore, ops[1], mode, 8, CPU)
    assert got["rows"] == ref["rows"]
    assert got["counters"] == ref["counters"], cases.COUNTERS
    assert got["stages"] == ref["stages"], cases.STAGE_COUNTERS


def test_interpret_engages_the_kernel_tier(ops):
    # reduceByKey with a builtin fn rides the kernels at any p; partitionBy
    # and join route through the bucket kernel only where there is an
    # exchange (p > 1)
    for name, p in (("filter_rbk_add", 1), ("partition_by", 8), ("join", 8)):
        got = cases.run_case(name, tcore, ops[1], "interpret", p, CPU)
        hits = got["counters"][cases.COUNTERS.index("kernel_hits")]
        assert hits >= 1, name


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p", [1, 8])
def test_reduced_block_equal_with_padding_and_positions(mode, p, jax_p8):
    """The whole capacity-padded block after a wide stage — padding rows and
    row positions included — carried across with the interop helpers."""
    if p == 1:
        ref = cases.reduced_block_leaves(jcore, mode, 1)
    else:
        _, blocks = jax_p8.result()
        ref = {k: blocks[f"{mode}_{k}"] for k in ("key", "value", "valid")}
    got = cases.reduced_block_leaves(tcore, mode, p, CPU)
    carried = block_from_reference({"key": ref["key"], "value": ref["value"]},
                                   ref["valid"], p)
    data, valid = block_to_numpy(carried)
    assert np.array_equal(valid, got["valid"])
    for k in ("key", "value"):
        assert data[k].dtype == got[k].dtype
        assert np.array_equal(data[k], got[k])
    assert valid.shape[0] % p == 0 and valid.sum() == 13


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the cuda default is satisfiable")
    with pytest.raises(RuntimeError, match="ignis.device=cuda"):
        tcore.ICluster(tcore.IProperties())


@pytest.mark.parametrize("mode", MODES)
def test_gang_scheduled_job_on_rank_groups(mode, ops):
    """IJob(gang=2) deals submissions onto the two halves of the 8 ranks;
    each half's wide stages run over its own 4 ranks and agree with the
    whole world's answer."""
    w = tcore.IWorker(tcore.ICluster(tcore.IProperties(
        {**CPU, "ignis.executor.instances": "8", "ignis.kernels": mode})), "python")
    rows = []
    for _ in range(2):
        kv = (w.parallelize(cases.VALS).map(lambda x: {"key": x % 13, "value": x})
              .reduce_by_key(lambda a, b: a + b, 0))
        rows.append(cases.rows_key(kv.collect()))
    job = tcore.IJob("gang", gang=2)
    futs = [(w.parallelize(cases.VALS).map(lambda x: {"key": x % 13, "value": x})
             .reduce_by_key(lambda a, b: a + b, 0)).collect_async(job=job)
            for _ in range(2)]
    assert [cases.rows_key(f.result()) for f in futs] == rows
    summary = job.metrics("tasks")
    assert summary["gang"] >= 2 and summary["groups"] == ["data[0:4]", "data[4:8]"]
