"""The port's chaos matrix, held against the JAX package: every case of
tests/test_faults.py and tests/_faults_main.py — every task kind (narrow,
fused, wide over every shuffle kind, native, reshard, action), the retry
budget, checkpoint-truncated repair, speculative duplication, executor kill
and blacklist, ``unpersist``, collective handles, the ``kernel.*`` and
``stream.*`` sites, and at p = 8 the overflow retry, the inter-group reshard
edge, the ``elastic.reshard`` site and resizes under gang tasks and
streaming pumps — runs under the same ``FaultPlan`` on both packages, and
gives the same rows and the same counters (scheduler retries, injections,
restores, recomputes, replays).

At p = 1 both packages run in this process; at p = 8 the JAX package runs
in a subprocess (tests/_torch_recovery_main.py, 8 fake XLA host devices)
started once for the module.
"""
import os
import sys

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_recovery_cases as cases  # noqa: E402

from repro.core import faults as jfaults  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def jax_p8(tmp_path_factory):
    ref = cases.start_reference("faults", tmp_path_factory.mktemp("faults") / "p8.json")
    yield ref
    ref.stop()


@pytest.fixture(scope="module")
def pkgs():
    return cases.Pkg("jax", 1), cases.Pkg("torch", 1)


@pytest.mark.parametrize("name", sorted(cases.FAULTS))
def test_p1_matches_jax(name, pkgs):
    jpkg, tpkg = pkgs
    want = cases.as_json(cases.FAULTS[name](jpkg, 1))
    got = cases.as_json(cases.FAULTS[name](tpkg, 1))
    assert not cases.held(want), cases.held(want)
    assert got == want


@pytest.mark.parametrize("name", sorted(cases.GROUPS["faults"]))
def test_p8_matches_jax(name, jax_p8):
    got = cases.as_json(cases.GROUPS["faults"][name](cases.Pkg("torch", 8), 8))
    want = jax_p8()[name]
    assert not cases.held(want), cases.held(want)
    assert got == want


def test_p8_exact_counters_of_the_reference_suite(jax_p8):
    """The counters tests/_faults_main.py asserts, read off the port's own
    p = 8 run of the same cases."""
    t = cases.Pkg("torch", 8)
    rec = cases.f_elastic_reshard_fault(t, 8)
    assert rec["injections"] == 1 and rec["hole"] and rec["same"]
    assert rec["elastic"]["reshard_recomputes"] == 1
    assert rec["elastic"]["reshard_moves"] == 7  # 8 blocks, 1 lost, 0 kept
    assert rec["recomputes"] == 1 and rec["retries"] == 0
    st = cases.f_stream_groups(t, 8)
    assert st["same"] and st["retries"] == 1 and st["replayed"] == 1
    assert st["restart"]["restored_from"] == 4 and st["restart"]["replayed"] == 0
    assert st["restart"]["committed"] == 6 and st["restart"]["offset"] == 96


# ---------------------------------------------------------------------------
# the FaultPlan rule machinery, both packages alike
# ---------------------------------------------------------------------------

FAULTS = {"jax": jfaults, "torch": tfaults}


@pytest.mark.parametrize("pkg", sorted(FAULTS))
def test_rule_fires_on_exact_attempt(pkg):
    F = FAULTS[pkg]
    plan = F.FaultPlan().kill_block(op="map", block=1, attempt=1)
    plan.check("dag.block", op="map", block=1)
    with pytest.raises(F.FaultInjected):
        plan.check("dag.block", op="map", block=1)
    plan.check("dag.block", op="map", block=1)
    assert plan.injections() == 1 and plan.injections("dag.block") == 1


@pytest.mark.parametrize("pkg", sorted(FAULTS))
def test_rule_match_glob_and_times(pkg):
    F = FAULTS[pkg]
    plan = F.FaultPlan().kill_block(op="map", block=0)
    plan.check("dag.block", op="mapValues", block=0)  # exact, not a substring
    with pytest.raises(F.FaultInjected):
        plan.check("dag.block", op="map", block=0)
    plan = F.FaultPlan().fail("job.task", name="collect(*", attempt=None, times=2)
    for _ in range(2):
        with pytest.raises(F.FaultInjected):
            plan.check("job.task", name="collect(map#3)", kind="action", attempt=0)
    plan.check("job.task", name="collect(map#3)", kind="action", attempt=0)
    assert plan.injections() == 2


@pytest.mark.parametrize("pkg", sorted(FAULTS))
def test_inject_nesting_and_seeded_choice(pkg):
    F = FAULTS[pkg]
    a, b = F.FaultPlan(), F.FaultPlan()
    with F.inject(a):
        with F.inject(b):
            assert F.active() is b
        assert F.active() is a
    assert F.active() is None
    assert len({F.FaultPlan(seed=7).choice(range(100)) for _ in range(3)}) == 1
    assert (jfaults.FaultPlan(seed=7).choice(range(100))
            == tfaults.FaultPlan(seed=7).choice(range(100)))
