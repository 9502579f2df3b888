"""The port's kernel wrappers against the JAX package's kernels.

On the CPU every wrapper runs its kernel's plain torch version; the JAX
kernels run in Pallas interpret mode, as tests/test_kernel_conformance.py
runs them. Inputs are made with numpy from a seed and fed to both.

Ints, max/min and integer-valued f32 must match bit for bit. Random f32
sums match to rtol=1e-5: the association order of the scans differs.

chip_smoke.py holds the CUDA kernels against these plain versions on
the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.moe_route import bucket_route as jax_bucket_route  # noqa: E402
from repro.kernels.segment_reduce import segment_totals as jax_segment_totals  # noqa: E402
from repro.kernels.ssd_scan import prefix_scan as jax_prefix_scan  # noqa: E402
from repro_torch.core import shuffle as tsh  # noqa: E402
from repro_torch.kernels.moe_route import bucket_route, bucket_route_ref  # noqa: E402
from repro_torch.kernels.segment_reduce import segment_totals  # noqa: E402
from repro_torch.kernels.ssd_scan import prefix_scan, prefix_scan_ref  # noqa: E402

OPS = ("sum", "max", "min")
_IDENT = {"sum": 0, "max": -(2**31 - 1), "min": 2**31 - 1}


def bits_equal(got, ref):
    g, r = np.asarray(got), np.asarray(ref)
    return g.dtype == r.dtype and g.shape == r.shape and np.array_equal(g, r)


def _data(n, dtype, seed=0):
    """Integer-valued samples: every op is associative-exact."""
    r = np.random.default_rng(seed).integers(-1000, 1000, n)
    if dtype == "bool":
        return r % 2 == 0
    return r.astype(dtype)


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.array(a)) for a in arrays]


# ---------------------------------------------------------------------------
# prefix_scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", ["float32", "int32", "bool"])
@pytest.mark.parametrize("n", [0, 1, 5, 200, 513])
def test_prefix_scan_matches_jax(op, dtype, n):
    x = _data(n, dtype, seed=n)
    (jx,), (tx,) = _both(x)
    for reverse in (False, True):
        ref = jax_prefix_scan(jx, op=op, block=64, interpret=True, reverse=reverse)
        got = prefix_scan(tx, op=op, block=64, reverse=reverse)
        assert bits_equal(got, ref)


def test_prefix_scan_random_f32_sum_within_tolerance():
    x = np.random.default_rng(1).random(777).astype(np.float32)
    ref = jax_prefix_scan(jnp.asarray(x), op="sum", block=64, interpret=True)
    got = prefix_scan(torch.from_numpy(x), op="sum", block=64)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5)


# ---------------------------------------------------------------------------
# the flat multi-rank layout: one call over every rank == a call per rank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("p,m", [(8, 40), (4, 33), (2, 1)])
def test_flat_rank_layout_equals_per_rank_calls(op, p, m):
    rng = np.random.default_rng(p * 100 + m)
    # each rank's keys sorted on their own, and rank r+1 starting with the
    # key rank r ends on: only the per-rank head rule keeps them apart
    keys = np.concatenate([np.sort(rng.integers(0, 5, m)) for _ in range(p)])
    keys[m - 1::m] = 4
    keys[m::m] = 4
    keys = keys.astype(np.int32)
    valid = rng.random(p * m) < 0.85
    vals = rng.integers(-50, 50, p * m).astype(np.int32)
    _, (tk, tv, tx) = _both(keys, valid, vals)
    h, t = segment_totals(tk, tv, tx, op, _IDENT[op], block=16, seg=m)
    for r in range(p):
        sl = slice(r * m, (r + 1) * m)
        hr, tr = segment_totals(tk[sl], tv[sl], tx[sl], op, _IDENT[op], block=16)
        assert bits_equal(h[sl], hr) and bits_equal(t[sl], tr)
        assert bool(h[r * m]) == bool(valid[r * m])  # every rank's row 0 is first
    if p == 8:  # and the per-rank calls are the reference's per-shard calls
        jk, jv, jx = (jnp.asarray(a[:m]) for a in (keys, valid, vals))
        hr, tr = jax_segment_totals(jk, jv, jx, op, jnp.int32(_IDENT[op]),
                                    block=16, interpret=True)
        assert bits_equal(h[:m], hr) and bits_equal(t[:m], tr)


@pytest.mark.parametrize("p,n,C", [(8, 40, 7), (4, 100, 30), (2, 5, 1)])
def test_batched_router_equals_per_rank_calls(p, n, C):
    rng = np.random.default_rng(n + p)
    dest = rng.integers(0, p, (p, n)).astype(np.int32)
    route = tsh.make_bucket_route(p, C, block=16)
    pos, keep, counts = route(torch.from_numpy(dest))
    for r in range(p):
        ref = bucket_route(torch.from_numpy(dest[r]), p, C, block=16)
        assert bits_equal(pos[r], ref[0])
        assert bits_equal(keep[r], ref[1])
        assert bits_equal(counts[r], ref[2])
    ref = jax_bucket_route(jnp.asarray(dest[0]), p, C, block=16, interpret=True)
    assert all(bits_equal(g[0], x) for g, x in zip((pos, keep, counts), ref))


# ---------------------------------------------------------------------------
# bucket_route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,p,capacity", [
    (0, 4, 2),          # empty
    (1, 2, 1),          # single row
    (100, 8, 20),       # roomy
    (100, 8, 5),        # C smaller than the demand: overflow rows dropped
    (600, 2, 400),      # multi-block
    (257, 5, 1),        # capacity 1, ragged tail
])
def test_bucket_route_matches_jax(n, p, capacity):
    dest = np.random.default_rng(n + p).integers(0, p, n).astype(np.int32)
    ref = jax_bucket_route(jnp.asarray(dest), p, capacity, block=64, interpret=True)
    got = bucket_route(torch.from_numpy(dest), p, capacity, block=64)
    for g, r in zip(got, ref):
        assert bits_equal(g, r)


def test_bucket_route_all_one_destination():
    dest = torch.zeros(90, dtype=torch.int32)
    pos, keep, counts = bucket_route(dest, 4, 100, block=32)
    assert bits_equal(pos, np.arange(90, dtype=np.int32))
    assert bool(keep.all()) and counts[0] == 90 and int(counts.sum()) == 90
    ref = jax_bucket_route(jnp.zeros(90, jnp.int32), 4, 100, block=32, interpret=True)
    for g, r in zip((pos, keep, counts), ref):
        assert bits_equal(g, r)


def test_bucket_route_sentinel_claims_nothing():
    dest = torch.tensor([0, 3, 1, 3, 0], dtype=torch.int32)  # 3 = p: padding
    pos, keep, counts = bucket_route_ref(dest, 3, 4)
    assert pos.tolist() == [0, 0, 0, 0, 1]
    assert keep.tolist() == [True, False, True, False, True]
    assert counts.tolist() == [2, 1, 0]


# ---------------------------------------------------------------------------
# device dispatch: the kernels need the card
# ---------------------------------------------------------------------------


def test_plain_versions_run_on_cpu_tensors_without_counting_launches():
    from repro_torch import kernels

    kernels.reset_launches()
    prefix_scan(torch.arange(10, dtype=torch.int32), op="min", block=4)
    segment_totals(torch.zeros(8, dtype=torch.int32), torch.ones(8, dtype=torch.bool),
                   torch.ones(8, dtype=torch.int32), "sum", 0, block=4)
    bucket_route(torch.zeros(8, dtype=torch.int32), 2, 4, block=4)
    assert all(f.launches == 0 and f.tune_launches == 0
               for f in kernels.launch_counters().values())
