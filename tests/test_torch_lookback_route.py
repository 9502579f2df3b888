"""The dataflow of the port's one-pass prefix scan and bucket router
(``prefix_scan_fwd`` in ``csrc/segment_reduce.cu``, ``csrc/bucket_route.cu``),
mirrored in plain torch, against the JAX package's Pallas kernels and the
plain versions.

A CUDA kernel cannot run here, so ``prefix_scan_lookback`` and
``bucket_route_lookback`` repeat its steps with the tile size (and the
router's warps a tile) as parameters: each tile's own scan or count, the
walk back over the aggregates of the tiles before it, the reverse
direction, the ragged tail. The JAX kernels run in Pallas interpret mode,
as tests/test_kernel_conformance.py runs them; inputs are made with numpy
from a seed and fed to both.

Integers, max/min and integer-valued f32 must match bit for bit (NaN rows
where the reference has them); random f32 sums to rtol 1e-5, atol 1e-4 (the
association order differs). On the card the kernel's random f32 sums
are held against the scan in float64: their largest error at most
``F32_SUM_ERR_RATIO`` times torch.cumsum's own
(tests/test_torch_card_kernels.py). Router ordinals, keep flags
and counts bit for bit.

On the card tests/test_torch_card_kernels.py holds the CUDA kernels
against the plain versions at edge shapes, chip_smoke.py at its paths'
inputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.moe_route import bucket_route as j_bucket_route  # noqa: E402
from repro.kernels.ssd_scan import prefix_scan as j_prefix_scan  # noqa: E402
from repro_torch.kernels import launch_counters, reset_launches  # noqa: E402
from repro_torch.kernels.moe_route import route  # noqa: E402
from repro_torch.kernels.moe_route.ref import (  # noqa: E402
    bucket_route_lookback, bucket_route_ref)
from repro_torch.kernels.ssd_scan.ops import prefix_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.prefix import prefix_scan_fwd  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import prefix_scan_lookback, prefix_scan_ref  # noqa: E402

OPS = ("sum", "max", "min")
TILE = 16  # the mirror's rows a tile; the JAX kernel's block is 64
LENGTHS = (1, TILE - 1, TILE, TILE + 1, 3 * TILE + 1)
#: where a NaN row goes: the first row, mid-tile, a tile's first row, the last
NAN_AT = {"first": lambda n: 0, "mid": lambda n: min(TILE // 2, n - 1),
          "edge": lambda n: min(TILE, n - 1), "last": lambda n: n - 1}


def _ints(n, seed):
    return np.random.default_rng(seed).integers(-50, 50, n)


def _jax_scan(x, op, reverse):
    return np.asarray(j_prefix_scan(jnp.asarray(x), op=op, block=64, interpret=True,
                                    reverse=reverse))


# ---------------------------------------------------------------------------
# the prefix scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("op", OPS)
def test_prefix_mirror_matches_the_jax_kernel(op, dtype, n, reverse):
    """int32 and integer-valued f32, bit for bit; N a tile's rows - 1, a
    tile, + 1 and three tiles + 1, both directions."""
    x = _ints(n, n + len(op)).astype(dtype)
    got = prefix_scan_lookback(torch.from_numpy(x), op, reverse, TILE)
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), _jax_scan(x, op, reverse))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("at", sorted(NAN_AT))
@pytest.mark.parametrize("op", ["max", "min"])
def test_prefix_mirror_keeps_nan_rows_as_the_jax_kernel(op, at, n, reverse):
    """f32 max/min with a NaN row at the first row, mid-tile, at a tile's
    edge or last: NaN from it on in scan order, as jnp.maximum/minimum and
    torch.cummax/cummin give, and the kernel's pick combine reproduces."""
    x = _ints(n, n).astype(np.float32)
    x[NAN_AT[at](n)] = np.nan
    got = prefix_scan_lookback(torch.from_numpy(x), op, reverse, TILE)
    want = _jax_scan(x, op, reverse)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isnan(want).any()
    ref = prefix_scan_ref(torch.from_numpy(x), op, reverse)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("op", ["max", "min"])
def test_plain_prefix_scan_keeps_nan_as_the_jax_kernel(op, reverse):
    """The port's wrapper on a CPU tensor (the plain version) keeps every NaN
    row of f32 max/min, as the Pallas kernel does; signed zeros come out as
    torch.cummax/cummin give them."""
    x = _ints(3 * 64 + 5, 7).astype(np.float32)
    x[[3, 64, 100]] = np.nan
    x[[10, 11, 150]] = [0.0, -0.0, -0.0]
    got = prefix_scan(torch.from_numpy(x), op=op, block=64, reverse=reverse)
    np.testing.assert_array_equal(got.numpy(), _jax_scan(x, op, reverse))
    mirror = prefix_scan_lookback(torch.from_numpy(x), op, reverse, 64)
    assert torch.equal(got.view(torch.int32), mirror.view(torch.int32))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [TILE + 1, 3 * TILE + 1, 1000])
def test_prefix_mirror_random_f32_sums_within_tolerance(n, reverse):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = prefix_scan_lookback(torch.from_numpy(x), "sum", reverse, TILE)
    np.testing.assert_allclose(got.numpy(), _jax_scan(x, "sum", reverse), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("reverse", [False, True])
def test_prefix_mirror_takes_bool_and_empty_inputs(reverse):
    b = torch.from_numpy(np.random.default_rng(3).random(3 * TILE + 1) < 0.2)
    for op in OPS:
        assert torch.equal(prefix_scan_lookback(b, op, reverse, TILE),
                           prefix_scan_ref(b, op, reverse))
    out = prefix_scan_lookback(torch.zeros(0, dtype=torch.int32), "min", reverse, TILE)
    assert out.shape == (0,) and out.dtype == torch.int32


def test_prefix_cpu_calls_take_reverse_and_count_no_launch():
    reset_launches()
    x = torch.from_numpy(_ints(100, 1).astype(np.int32))
    assert torch.equal(prefix_scan_fwd(x, "min", 32, reverse=True),
                       prefix_scan_ref(x, "min", reverse=True))
    fn = launch_counters()["prefix_scan"]
    assert fn.launches == 0 and fn.tune_launches == 0


# ---------------------------------------------------------------------------
# the bucket router
# ---------------------------------------------------------------------------


def _route_equal(got, want):
    for a, b, name in zip(got, want, ("pos", "keep", "counts")):
        assert a.dtype == {"pos": torch.int32, "keep": torch.bool, "counts": torch.int32}[name]
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def _dests(kind, n, p, seed):
    rng = np.random.default_rng(seed)
    if kind == "one":  # every row to one bucket
        return np.full(n, p // 2, np.int32)
    d = rng.integers(0, p, n).astype(np.int32)
    if kind == "sentinel":  # a fifth of the rows to the sentinel p
        d[rng.random(n) < 0.2] = p
    if kind == "past":  # a fifth past it, some whose low bits name a bucket
        past = rng.random(n) < 0.2
        d[past] = p + rng.integers(1, 3 * p + 3, int(past.sum()))
    return d


@pytest.mark.parametrize("kind", ["random", "sentinel", "past", "one"])
@pytest.mark.parametrize("p,n,tile,warps", [
    (2, 600, 64, 2),     # tiles of 64 rows, 32 rows a warp: runs cross every edge
    (5, 601, 96, 3),     # a ragged tail
    (64, 1000, 256, 4),  # the hybrid join's P
    (256, 700, 128, 1),  # one warp a tile
])
def test_router_mirror_matches_the_jax_kernel(p, n, tile, warps, kind):
    """C below the demand of the fullest bucket, so keep drops rows; all
    rows to one bucket across every tile; rows to the sentinel or past it,
    which claim no ordinal; bit for bit against the Pallas kernel and the
    plain version."""
    d = _dests(kind, n, p, p + n)
    C = max(1, n // p // 2)
    got = bucket_route_lookback(torch.from_numpy(d), p, C, tile, warps)
    _route_equal(got, j_bucket_route(jnp.asarray(d), p, C, block=64, interpret=True))
    _route_equal(got, bucket_route_ref(torch.from_numpy(d), p, C))
    assert not got[1].all()


@pytest.mark.parametrize("p,n,tile,warps", [
    (4096, 3000, 96, 3),   # the most buckets chip_smoke.py holds the kernel at
    (4096, 5000, route.geometry(4096, 512)[1], route.geometry(4096, 512)[0]),
    (64, 20001, 1024, 16), # 20 tiles and a ragged one
    (9, 1, 32, 1),         # one row
])
def test_router_mirror_matches_the_plain_version(p, n, tile, warps):
    d = torch.from_numpy(_dests("sentinel", n, p, n))
    for C in (1, n):
        _route_equal(bucket_route_lookback(d, p, C, tile, warps), bucket_route_ref(d, p, C))


def test_router_mirror_takes_an_empty_input_and_refuses_a_broken_tile():
    pos, keep, counts = bucket_route_lookback(torch.zeros(0, dtype=torch.int32), 4, 2, 64, 2)
    assert pos.shape == (0,) and keep.shape == (0,)
    assert torch.equal(counts, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="rounds of 32 rows"):
        bucket_route_lookback(torch.zeros(8, dtype=torch.int32), 4, 2, 48, 1)


@pytest.mark.parametrize("p", [2, 9, 64, 256, 1024, 4096, 6144, 6145, route.MAX_BUCKETS])
@pytest.mark.parametrize("block", [32, 128, 512])
def test_router_geometry_fits_any_p(p, block):
    """The warps' tables and the tile's counts fit the block's shared memory
    (one warp above ``TABLE_BYTES``, within 128 KB), a warp walks whole
    batches of rounds of 32 rows, and a tile holds at least 16 rows a
    bucket, so the look-back's words stay an eighth of the tile's input."""
    warps, rows = route.geometry(p, block)
    assert 1 <= warps <= max(1, min(block, 512) // 32)
    assert (warps + 1) * 4 * p <= route.TABLE_BYTES or (warps == 1 and 8 * p <= 128 * 1024)
    assert rows % (32 * route.ROUNDS_AT_ONCE * warps) == 0
    assert rows >= 16 * p and 8 * p <= rows * 4 / 8
    n = 3 * rows + 1
    assert route.scratch_bytes(n, p, block) == 8 + 8 * 4 * p
    assert route.scratch_bytes(rows, p, block) == 0


@pytest.mark.parametrize("n,p", [(1, 2), (1000, 64), (4097, 5), (2**20, 64)])
def test_router_outputs_share_one_buffer(n, p):
    """The wrapper's three outputs are views of one int32 allocation: pos at
    byte 0, counts at 4n, keep at 4n + 4p, then the look-back's scratch from
    5n + 4p rounded up to 8 bytes."""
    scratch = route.scratch_bytes(n, p, 512)
    pos, keep, counts, buf, off = route.outputs(n, p, scratch, torch.device("cpu"))
    for t, dt, size in ((pos, torch.int32, n), (keep, torch.bool, n), (counts, torch.int32, p)):
        assert t.shape == (size,) and t.dtype == dt and t.is_contiguous()
        assert t.untyped_storage().data_ptr() == buf.data_ptr()
    base = buf.data_ptr()
    assert [t.data_ptr() - base for t in (pos, counts, keep)] == [0, 4 * n, 4 * n + 4 * p]
    assert off % 8 == 0 and off >= 5 * n + 4 * p and 4 * buf.numel() >= off + scratch
    pos.fill_(-3), keep.fill_(True), counts.fill_(9)  # no two views overlap
    assert (pos == -3).all() and keep.all() and (counts == 9).all()


def test_router_cpu_calls_count_no_launch():
    reset_launches()
    route.bucket_route_fwd(torch.zeros(100, dtype=torch.int32), 4, 10, block=32)
    fn = launch_counters()["bucket_route"]
    assert fn.launches == 0 and fn.tune_launches == 0
