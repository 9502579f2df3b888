"""The dataflow of the port's two one-pass CUDA kernels with a decoupled
look-back (``csrc/segment_reduce.cu``, ``csrc/moe_route.cu``), mirrored in
plain torch, against the JAX package's Pallas kernels and the plain versions.

A CUDA kernel cannot run here, so ``segment_scan_lookback`` and
``moe_route_lookback`` repeat its steps with the tile size as a parameter:
each tile's own scan and aggregate, the walk back over the aggregates of
the tiles before it, and each tile's rows with the carried prefix. The JAX
kernels run in Pallas interpret mode, as tests/test_kernel_conformance.py
runs them; inputs are made with numpy from a seed and fed to both.

Integers, max/min and integer-valued f32 must match bit for bit; random f32
sums to rtol 1e-5, atol 1e-4 (the association order differs), the
tolerance chip_smoke.py holds the kernel to on the card. Router ids,
ordinals and keep flags bit for bit, weights within 1e-6.

chip_smoke.py holds the CUDA kernels against the plain versions on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.moe_route import moe_route as j_moe_route  # noqa: E402
from repro.kernels.moe_route import moe_route_ref as j_moe_route_ref  # noqa: E402
from repro.kernels.segment_reduce.segment_reduce import (  # noqa: E402
    segment_reduce_fwd as j_segment_reduce_fwd)
from repro_torch.kernels import launch_counters, reset_launches  # noqa: E402
from repro_torch.kernels.moe_route.moe_route import moe_route_fwd, outputs  # noqa: E402
from repro_torch.kernels.moe_route.ref import moe_route_lookback, moe_route_ref  # noqa: E402
from repro_torch.kernels.segment_reduce.ref import (  # noqa: E402
    segment_scan_lookback, segment_scan_plain)

OPS = ("sum", "max", "min")
W_ATOL = 1e-6
N_JAX = 320  # a multiple of the JAX kernel's block (64), as its wrapper pads


def _flags(kind, n, seed):
    """Boundaries: only at row 0 (one segment spanning every tile), at
    every row, or at random rows (about one in six)."""
    if kind == "row0":
        f = np.zeros(n, bool)
    elif kind == "every":
        f = np.ones(n, bool)
    else:
        f = np.random.default_rng(seed).random(n) < 0.17
    f[0] = True
    return f


def _values(n, d, dtype, seed):
    return np.random.default_rng(seed).integers(-50, 50, (n, d)).astype(dtype)


# ---------------------------------------------------------------------------
# the segmented scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("kind", ["random", "row0", "every"])
@pytest.mark.parametrize("tile", [7, 64, 100])
def test_segment_mirror_matches_the_jax_kernel(op, dtype, d, kind, tile):
    """Tiles of 7 and 100 rows put boundaries and segments across every
    tile edge; with boundaries only at row 0 every tile's look-back walks
    to the first tile."""
    v, f = _values(N_JAX, d, dtype, d + tile), _flags(kind, N_JAX, tile)
    want = np.asarray(j_segment_reduce_fwd(jnp.asarray(v), jnp.asarray(f), op=op, block=64,
                                           interpret=True))
    got = segment_scan_lookback(torch.from_numpy(v), torch.from_numpy(f), op, tile)
    assert got.dtype == torch.from_numpy(v).dtype and got.shape == v.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,tile", [(1, 16), (16, 16), (17, 16), (15, 16), (1000, 1),
                                    (4097, 64)])
@pytest.mark.parametrize("kind", ["random", "row0", "every"])
def test_segment_mirror_matches_the_plain_version(n, tile, kind):
    """Ragged N at tile multiples ± 1, a single tile, a tile per row; random
    f32 sums within the card's tolerance, max exactly."""
    f = torch.from_numpy(_flags(kind, n, n))
    v = torch.from_numpy(np.random.default_rng(n).standard_normal((n, 2)).astype(np.float32))
    torch.testing.assert_close(segment_scan_lookback(v, f, "sum", tile),
                               segment_scan_plain(v, f, "sum"), rtol=1e-5, atol=1e-4)
    assert torch.equal(segment_scan_lookback(v, f, "max", tile), segment_scan_plain(v, f, "max"))


def test_segment_mirror_takes_an_empty_input():
    v = torch.zeros((0, 2), dtype=torch.int32)
    out = segment_scan_lookback(v, torch.zeros(0, dtype=torch.bool), "sum", 8)
    assert out.shape == (0, 2) and out.dtype == torch.int32


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------


def _logits(seed, T, E, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, E)).astype(np.float32)
    if ties:  # whole rows equal, the top two equal, and equal runners-up
        x[::3] = 0.5
        x[1::3, :2] = 2.0
        x[2::3, 1:] = x[2::3, 1:2]
    return x


def _route_equal(got, want):
    (wt, it, pt, kt), (wj, ij, pj, kj) = got, want
    assert it.dtype == torch.int32 and pt.dtype == torch.int32 and kt.dtype == torch.bool
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=W_ATOL, rtol=0)


@pytest.mark.parametrize("T,E,k,C,tile,ties", [
    (512, 8, 2, 64, 7, False),     # tiles of 7 tokens: experts' runs cross every edge
    (512, 8, 2, 64, 100, True),
    (300, 16, 2, 30, 256, False),  # the kernel's tile: one full tile and a ragged one
    (300, 4, 1, 40, 33, True),
    (1024, 64, 2, 20, 256, False),  # the kernel's most experts
    (4, 8, 2, 2, 256, False),      # a decode tick: 4 slots in one tile
])
def test_router_mirror_matches_the_jax_kernel(T, E, k, C, tile, ties):
    x = _logits(T + E + tile, T, E, ties)
    got = moe_route_lookback(torch.from_numpy(x), k, C, tile)
    _route_equal(got, j_moe_route(jnp.asarray(x), k, C, 256, True))
    _route_equal(got, j_moe_route_ref(jnp.asarray(x), k, C))
    assert (got[2] >= C).any() == (not got[3].all())


@pytest.mark.parametrize("T,tile", [(1, 256), (4, 256), (255, 256), (256, 256), (257, 256),
                                    (2049, 256), (600, 1)])
def test_router_mirror_matches_the_plain_version(T, tile):
    """T at the kernel's tile size ± 1, in one tile and in many, and a tile
    per token; with non-finite rows (NaN-ranked experts 0 and 1)."""
    x = torch.from_numpy(_logits(T, T, 8))
    x[::5, 3] = float("nan")
    x[1::7] = float("-inf")
    C = max(1, T // 8)
    for a, b in zip(moe_route_lookback(x, 2, C, tile)[1:], moe_route_ref(x, 2, C)[1:]):
        assert torch.equal(a, b)
    w, wr = moe_route_lookback(x, 2, C, tile)[0], moe_route_ref(x, 2, C)[0]
    assert torch.equal(w.isnan(), wr.isnan())
    torch.testing.assert_close(torch.nan_to_num(w), torch.nan_to_num(wr), atol=W_ATOL, rtol=0)


@pytest.mark.parametrize("T,k,E", [(4, 2, 8), (2048, 2, 8), (257, 1, 64), (1, 1, 4)])
def test_router_outputs_share_one_buffer(T, k, E):
    """The wrapper's four outputs are views of one int32 allocation (f32 weights,
    i32 ids, i32 ordinals and bool keep flags, each (T, k) contiguous, at
    byte offsets 0, 4Tk, 8Tk and 12Tk, so 4-byte aligned), followed by the
    look-back's scratch from 13Tk rounded up to 8 bytes: a counter and a
    word per (tile, expert) where there is more than one tile."""
    w, idx, pos, keep, buf = outputs(T, k, E, torch.device("cpu"))
    n = T * k
    for t, dt in ((w, torch.float32), (idx, torch.int32), (pos, torch.int32),
                  (keep, torch.bool)):
        assert t.shape == (T, k) and t.dtype == dt and t.is_contiguous()
        assert t.untyped_storage().data_ptr() == buf.data_ptr()
    base = buf.data_ptr()
    assert [t.data_ptr() - base for t in (w, idx, pos, keep)] == [0, 4 * n, 8 * n, 12 * n]
    tiles = -(-T // 256)
    off = -(-13 * n // 8) * 8
    assert buf.dtype == torch.int32 and off % 8 == 0 and off >= 13 * n
    assert 4 * buf.numel() - off == (8 + 8 * tiles * E if tiles > 1 else 0)
    w.fill_(1.5), idx.fill_(-2), pos.fill_(7), keep.fill_(True)  # no two views overlap
    assert (w == 1.5).all() and (idx == -2).all() and (pos == 7).all() and keep.all()


def test_router_cpu_calls_count_no_launch():
    reset_launches()
    moe_route_fwd(torch.from_numpy(_logits(3, 600, 8)), 2, 100)
    fn = launch_counters()["moe_route"]
    assert fn.launches == 0 and fn.tune_launches == 0
