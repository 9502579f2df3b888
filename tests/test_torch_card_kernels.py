"""The port's hand-written CUDA kernels against their plain versions at edge
shapes, on an NVIDIA card: the segmented scan, the prefix scan, the bucket
router (alone and through their wrappers), flash attention's forward, the
SSD scan and the MoE router. Every case is marked ``cuda`` and skips without
a card; on one, ``pytest -m cuda tests/`` runs them with the decode kernel's,
flash backward's and the grouped expert products' (in their own files), and
``pytest -m cuda -k <kernel>`` one kernel's (``segment_reduce``,
``prefix_scan``, ``bucket_route``, ``flash_attention``, ``ssd_scan``,
``moe_route``).

Like ``chip_smoke.py``, which holds the same kernels at the inputs its
paths give them, this file imports neither jax nor repro, so it runs on a
card host without JAX; the tolerances the two share are the smoke's.
Integers and integer-valued floats are held bit for bit; each look-back
kernel's case is launched ``BACK_TO_BACK`` times with no synchronize
between them, and every result held, so a tile counter or look-back word
left over from the launch before shows.
"""
import itertools
import os
import sys

import pytest
import torch

from repro_torch.core.shuffle import segmented_reduce
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_fwd
from repro_torch.kernels.flash_attention.flash_attention import variant as flash_variant
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.moe_route.moe_route import moe_route_fwd
from repro_torch.kernels.moe_route.ops import bucket_route, moe_route
from repro_torch.kernels.moe_route.ref import bucket_route_ref, moe_route_ref
from repro_torch.kernels.moe_route.route import bucket_route_fwd, geometry
from repro_torch.kernels.segment_reduce.ops import segment_reduce, segment_totals
from repro_torch.kernels.segment_reduce.ref import segment_reduce_ref, segment_scan_plain
from repro_torch.kernels.segment_reduce.segment_reduce import rows_per_tile as seg_tile_rows
from repro_torch.kernels.segment_reduce.segment_reduce import segment_reduce_fwd
from repro_torch.kernels.ssd_scan.ops import prefix_scan, ssd_scan
from repro_torch.kernels.ssd_scan.prefix import prefix_scan_fwd
from repro_torch.kernels.ssd_scan.prefix import rows_per_tile as prefix_tile_rows
from repro_torch.kernels.ssd_scan.ref import prefix_scan_ref
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_fwd
from repro_torch.models.mamba2 import ssd_chunked

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from chip_smoke import (FLASH_BF16_REL_L2, FLASH_TOL, MOE_W_ATOL, SSD_TOL,  # noqa: E402
                        _Rand, _ssd_inputs, max_err, rel_l2, same_bits)

pytestmark = pytest.mark.cuda

OPS = ("sum", "max", "min")
DTYPES = {"int32": torch.int32, "float32": torch.float32, "bfloat16": torch.bfloat16}
#: back-to-back launches of each look-back kernel's case
BACK_TO_BACK = 3
#: N of the look-back kernels' cases, in tiles of their default block (256;
#: the bucket router's 512), and over 20000 tiles of block 32
TILE_EDGES = ("tile-1", "tile", "tile+1", "3tiles+1")
MANY_TILES = "20000tiles"


def _rows(at, tile, many_tile):
    """(N, block) of a case named ``at``, a tile holding ``tile`` rows at the
    default block and ``many_tile`` at block 32."""
    return {"1": (1, None), "tile-1": (tile - 1, None), "tile": (tile, None),
            "tile+1": (tile + 1, None), "3tiles+1": (3 * tile + 1, None),
            MANY_TILES: (many_tile * 20000 + 1, 32)}[at]


def _back_to_back(fwd, call, launches=BACK_TO_BACK, then=None):
    """``BACK_TO_BACK`` calls of ``call`` with no synchronize between them
    (and then one of ``then``), counted as ``launches`` launches of
    ``fwd``."""
    before = fwd.launches
    outs = [call() for _ in range(BACK_TO_BACK)] + ([then()] if then else [])
    assert fwd.launches == before + launches, f"not counted as {launches} launches"
    return outs


# ---------------------------------------------------------------------------
# the hybrid path's kernels through their wrappers: ragged N, N = 0 and 1,
# D in {1, 4}, every op, int32 / f32 / bool, a non-zero identity at invalid
# rows, the flat multi-rank layout, all rows to one destination, C below the
# demand, several scan levels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,d,dt", [(1, 1, "int32"), (1000, 4, "int32"), (4097, 1, "int32"),
                                    (70001, 4, "float32"), (300000, 1, "int32")])
@pytest.mark.parametrize("op", OPS)
def test_segment_reduce_wrappers_at_ragged_n(card, op, n, d, dt):
    """``segment_reduce`` and ``segment_totals`` (rank-flat, a non-zero
    identity) bit for bit; the values are integers."""
    r = _Rand(1)
    keys = torch.sort(r.ints(n, 0, max(n // 7, 1))).values
    valid = r.rand(n) < 0.8
    vals = r.ints(n, -50, 50, (n, d)).to(DTYPES[dt])
    hk, sk = segment_reduce(keys, valid, vals, op=op, block=128)
    hr, sr = segment_reduce_ref(keys, valid, vals, op=op)
    torch.testing.assert_close(hk, hr, rtol=0, atol=0, msg="heads")
    torch.testing.assert_close(sk, sr, rtol=0, atol=0, msg="sums")
    seg_len = max(n // 8, 1)
    ident = torch.tensor(41, dtype=vals.dtype, device=card)
    fn = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}[op]
    _, tk = segment_totals(keys, valid, vals, op, ident, block=128, seg=seg_len)
    _, tr = segmented_reduce(keys, valid, vals, fn, ident, seg=seg_len)
    torch.testing.assert_close(tk, tr, rtol=0, atol=0, msg=f"totals, seg={seg_len}")


def test_segment_totals_of_no_rows(card):
    z = torch.zeros(0, dtype=torch.int32, device=card)
    h, t = segment_totals(z, z.bool(), z, "sum", 0)
    assert h.shape == (0,) and t.shape == (0,)


def test_segment_reduce_wrapper_random_f32_sums(card):
    r = _Rand(1)
    fv = r.rand(70001, 4)
    keys = torch.sort(r.ints(70001, 0, 500)).values
    valid = torch.ones(70001, dtype=torch.bool, device=card)
    _, sk = segment_reduce(keys, valid, fv, op="sum", block=256)
    _, sr = segment_reduce_ref(keys, valid, fv, op="sum")
    torch.testing.assert_close(sk, sr, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("rev", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("dt", ["int32", "bool"])
@pytest.mark.parametrize("n", [0, 1, 5, 513, 100003, 3000001])
@pytest.mark.parametrize("op", OPS)
def test_prefix_scan_wrapper_at_ragged_n(card, op, n, dt, rev):
    r = _Rand(1)
    x = r.ints(n) if dt == "int32" else r.ints(n, 0, 2) == 0
    torch.testing.assert_close(prefix_scan(x, op=op, block=64, reverse=rev),
                               prefix_scan_ref(x, op=op, reverse=rev), rtol=0, atol=0)


def test_prefix_scan_wrapper_random_f32_sums(card):
    xf = _Rand(1).rand(100003)
    torch.testing.assert_close(prefix_scan(xf, op="sum"), prefix_scan_ref(xf, "sum"),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("n,p,c", [(0, 4, 2), (1, 2, 1), (100, 8, 5), (600, 2, 400),
                                   (257, 5, 1), (100003, 64, 900), (2000003, 64, 20000)])
def test_bucket_route_wrapper_at_ragged_n(card, n, p, c):
    d = _Rand(1).ints(n, 0, p)
    for a, b, nm in zip(bucket_route(d, p, c, block=64), bucket_route_ref(d, p, c),
                        ("pos", "keep", "counts")):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=nm)


def test_bucket_route_wrapper_all_rows_to_one_destination(card):
    one = torch.zeros(90, dtype=torch.int32, device=card)
    for a, b, nm in zip(bucket_route(one, 4, 100, block=32), bucket_route_ref(one, 4, 100),
                        ("pos", "keep", "counts")):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=nm)


# ---------------------------------------------------------------------------
# the segmented scan alone
# ---------------------------------------------------------------------------

#: the segmented scan's edge cases: D, then boundaries only at row 0 (one
#: segment over every tile: the look-back walks back until it meets a
#: published prefix), at every row, and at 5 % of the rows
SEG_EDGE_D = (1, 2, 3, 8)
SEG_EDGE_KINDS = ("row0", "every", "random")


def _seg_flags(r, kind, n):
    if kind == "row0":
        hb = torch.zeros(n, dtype=torch.bool, device=r.dev)
    elif kind == "every":
        hb = torch.ones(n, dtype=torch.bool, device=r.dev)
    else:
        hb = r.rand(n) < 0.05
    hb[0] = True
    return hb


@pytest.mark.parametrize("kind", SEG_EDGE_KINDS)
@pytest.mark.parametrize("at", ("1",) + TILE_EDGES + (MANY_TILES,))
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dt", ["int32", "float32"])
@pytest.mark.parametrize("d", SEG_EDGE_D)
def test_segment_reduce_kernel_at_edge_shapes(card, d, dt, op, at, kind):
    """``segment_reduce_fwd`` against ``segment_scan_plain``, bit for bit:
    the values are integers (the f32 ones too, every partial sum below
    2^24). Block 256: tiles of 4096 rows at D = 1, 1024 otherwise; over
    20000 tiles at block 32."""
    r = _Rand(8)
    n, block = _rows(at, seg_tile_rows(d, 256), seg_tile_rows(d, 32))
    block = block or 256
    vals = r.ints(n, -50, 50, (n, d)).to(DTYPES[dt])
    hb = _seg_flags(r, kind, n)
    outs = _back_to_back(segment_reduce_fwd,
                         lambda: segment_reduce_fwd(vals, hb, op=op, block=block))
    want = segment_scan_plain(vals, hb, op)
    for i, o in enumerate(outs):
        torch.testing.assert_close(o, want, rtol=0, atol=0, msg=f"launch {i + 1}")


@pytest.mark.parametrize("n", [4097, 70001, 1000001])
@pytest.mark.parametrize("d", SEG_EDGE_D)
def test_segment_reduce_kernel_random_f32_sums(card, d, n):
    """Random f32 sums at random boundaries: the association order
    differs, so within rtol 1e-5, atol 1e-4."""
    r = _Rand(8)
    vals, hb = r.rand(n, d) - 0.5, _seg_flags(r, "random", n)
    outs = _back_to_back(segment_reduce_fwd,
                         lambda: segment_reduce_fwd(vals, hb, op="sum", block=256))
    want = segment_scan_plain(vals, hb, "sum")
    for i, o in enumerate(outs):
        torch.testing.assert_close(o, want, rtol=1e-5, atol=1e-4, msg=f"launch {i + 1}")


# ---------------------------------------------------------------------------
# the prefix scan through its wrapper (which scans bool as int32 and passes
# ``reverse`` to the kernel)
# ---------------------------------------------------------------------------

#: a random f32 running sum's error depends on the order of its adds, and
#: grows with N: the kernel adds within a tile by a tree and across tiles by
#: the carry, torch.cumsum in CUB's order, so each is held against the scan in
#: float64, the kernel to this many times torch.cumsum's own error
F32_SUM_ERR_RATIO = 2.0
#: the prefix scan's inputs: int32, bool, integer-valued f32, and
#: integer-valued f32 with one NaN row (``PREFIX_NAN_AT``) and -0 rows
PREFIX_KINDS = ("int32", "bool", "f32", "f32-nan")
#: where the NaN row goes: the first row, mid-tile, a tile's first row, the last
PREFIX_NAN_AT = ("first", "mid", "edge", "last")
PREFIX_INPUTS = [k for k in PREFIX_KINDS if k != "f32-nan"] + [
    f"f32-nan-{at}" for at in PREFIX_NAN_AT]


def _prefix_input(r, kind, n, tile):
    v = r.ints(n, -50, 50)
    if kind == "int32":
        return v
    if kind == "bool":
        return v > 20
    v = v.float()
    if kind == "f32":
        return v
    v[v == 0] = -0.0
    at = kind.rsplit("-", 1)[1]
    v[{"first": 0, "mid": min(tile // 2, n - 1), "edge": min(tile, n - 1),
       "last": n - 1}[at]] = float("nan")
    return v


@pytest.mark.parametrize("at", TILE_EDGES + (MANY_TILES,))
@pytest.mark.parametrize("rev", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("kind", PREFIX_INPUTS)
@pytest.mark.parametrize("op", OPS)
def test_prefix_scan_kernel_at_edge_shapes(card, op, kind, rev, at):
    """Against ``prefix_scan_ref`` (torch.cumsum, cummax, cummin): max and
    min bit for bit, NaN payloads and zero signs included; sums bit for bit
    (integer-valued, every partial sum below 2^24), with NaN at the same
    rows where there is a NaN row. Block 256: tiles of 4096 rows; over 20000
    tiles at block 32."""
    r = _Rand(9)
    tile = prefix_tile_rows(256)
    n, block = _rows(at, tile, prefix_tile_rows(32))
    block = block or 256
    x = _prefix_input(r, kind, n, tile)
    outs = _back_to_back(prefix_scan_fwd,
                         lambda: prefix_scan(x, op=op, block=block, reverse=rev))
    want = prefix_scan_ref(x, op, rev)
    nan_rows = op == "sum" and "nan" in kind
    for i, o in enumerate(outs):
        assert same_bits(o, want, nan_rows), f"launch {i + 1}: max abs err {max_err(o, want)}"


@pytest.mark.parametrize("rev", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("n", [4097, 100003, 3000001])
def test_prefix_scan_kernel_random_f32_sums(card, n, rev):
    """Random f32 sums against the scan in float64: the kernel's largest
    error at most ``F32_SUM_ERR_RATIO`` times torch.cumsum's in float32 on
    the same input (or 1e-4)."""
    x = _Rand(9).rand(n) - 0.5
    exact64 = prefix_scan_ref(x.double(), "sum", rev)
    lib_err = max_err(prefix_scan_ref(x, "sum", rev), exact64)
    outs = _back_to_back(prefix_scan_fwd,
                         lambda: prefix_scan(x, op="sum", block=256, reverse=rev))
    for i, o in enumerate(outs):
        err = max_err(o, exact64)
        assert err <= max(F32_SUM_ERR_RATIO * lib_err, 1e-4), (
            f"launch {i + 1}: {err} from float64, torch.cumsum {lib_err}")


# ---------------------------------------------------------------------------
# the bucket router alone
# ---------------------------------------------------------------------------

#: the bucket router's bucket counts: the joins' P = p^2 at p = 2, 3, 4, 6
#: (4 and 6: the recovery phase's resized worlds), 8 and on to 64, and
#: 16384 (p = 128), whose one warp's table passes 48 KB
ROUTE_EDGE_P = (4, 9, 16, 36, 64, 256, 1024, 4096, 16384)
#: destinations random, a fifth of them the sentinel P, a fifth past it (ids
#: whose low bits name a real bucket among them), or all to one bucket
ROUTE_KINDS = ("random", "sentinel", "past", "one")


def _dests(r, kind, n, p):
    if kind == "one":
        return torch.full((n,), p // 2, dtype=torch.int32, device=r.dev)
    d = r.ints(n, 0, p)
    if kind == "sentinel":
        d[r.rand(n) < 0.2] = p
    if kind == "past":
        past = r.rand(n) < 0.2
        d[past] = r.ints(n, p + 1, 4 * p + 4)[past]
    return d


def _held_route(d, p, C, block):
    outs = _back_to_back(bucket_route_fwd,
                         lambda: bucket_route_fwd(d, p, C, block=block))
    want = bucket_route_ref(d, p, C)
    for i, got in enumerate(outs):
        for a, b, nm in zip(got, want, ("pos", "keep", "counts")):
            assert same_bits(a, b), f"launch {i + 1}: {nm} differs"
    return want


@pytest.mark.parametrize("cap", ["below", "above"])
@pytest.mark.parametrize("at", ("1",) + TILE_EDGES)
@pytest.mark.parametrize("kind", ROUTE_KINDS)
@pytest.mark.parametrize("p", ROUTE_EDGE_P)
def test_bucket_route_kernel_at_edge_shapes(card, p, kind, at, cap):
    """``bucket_route_fwd`` against ``bucket_route_ref`` (the stable
    argsort) at block 512, a capacity below the fullest bucket's demand or
    above every bucket's: pos, keep and counts bit for bit."""
    n, _ = _rows(at, geometry(p, 512)[1], 0)
    d = _dests(_Rand(10), kind, n, p)
    C = max(1, n // p // 2) if cap == "below" else n + 1
    want = _held_route(d, p, C, 512)
    if kind == "one" and C < n:
        assert not bool(want[1].all()), "rows past the capacity kept"


def test_bucket_route_kernel_all_rows_to_one_bucket_over_20001_tiles(card):
    n = geometry(64, 32)[1] * 20000 + 1
    want = _held_route(_dests(_Rand(10), "one", n, 64), 64, n // 3, 32)
    assert not bool(want[1].all())


def test_bucket_route_kernel_and_wrapper_of_no_rows(card):
    z = torch.zeros(0, dtype=torch.int32, device=card)
    for got in (bucket_route(z, 64, 5), bucket_route_fwd(z, 64, 5)):
        assert got[0].shape == (0,) and got[1].shape == (0,)
        assert torch.equal(got[2], torch.zeros(64, dtype=torch.int32, device=card))


# ---------------------------------------------------------------------------
# flash attention's forward
# ---------------------------------------------------------------------------

#: flash edge lengths: ragged against both routes' tiles, for both dtypes
FLASH_LENS = (1, 127, 129, 1000)
#: and, in bf16, lengths that span several of the wgmma route's 128-row and
#: 64-key tiles, the serve path's longest prompt among them
FLASH_LONG_LENS = (255, 1819, 2048)


def _flash_cases():
    """bf16 and f32, G in {1, 4, 5} (4: Mixtral's and Phi-3.5-MoE's GQA), hd
    in {64, 128, 256}, Sq and Skv in ``FLASH_LENS`` (in bf16 also
    ``FLASH_LONG_LENS``), causal on and off, window in {None, 16}, softcap
    in {0, 50}; a window where Sq > Skv leaves rows with no live column,
    which the plain version and the kernel define differently, so that pair
    is not a case."""
    for dt in ("bfloat16", "float32"):
        lens = FLASH_LENS + (FLASH_LONG_LENS if dt == "bfloat16" else ())
        for G, hd, Sq, Skv, causal, window, cap in itertools.product(
                (1, 4, 5), (64, 128, 256), lens, lens, (True, False), (None, 16), (0.0, 50.0)):
            if window is not None and Sq > Skv:
                continue
            yield pytest.param(dt, G, hd, Sq, Skv, causal, window, cap,
                               id=f"{dt}-G{G}-hd{hd}-{Sq}x{Skv}-{'causal' if causal else 'full'}"
                                  f"-window{window}-softcap{cap:g}")


@pytest.mark.parametrize("dt,G,hd,Sq,Skv,causal,window,cap", list(_flash_cases()))
def test_flash_attention_kernel_at_edge_shapes(card, dt, G, hd, Sq, Skv, causal, window, cap):
    """``flash_attention_fwd`` against ``attention_ref`` at q_offset = Skv -
    Sq where Sq <= Skv (0 otherwise): within ``FLASH_TOL``, bf16 also in
    relative L2 (``FLASH_BF16_REL_L2``), no NaN, one launch counted on the
    route ``variant`` gives its dtype and head dim."""
    dtype = DTYPES[dt]
    g = torch.Generator(device=card).manual_seed(2)
    K, B = 2, 2
    q = torch.randn((B, K * G, Sq, hd), generator=g, device=card).to(dtype) * 4
    k = torch.randn((B, K, Skv, hd), generator=g, device=card).to(dtype)
    v = torch.randn((B, K, Skv, hd), generator=g, device=card).to(dtype)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=Skv - Sq if Sq <= Skv else 0)
    on = flash_variant(dtype, hd)
    before = flash_attention_fwd.launches_by_variant.get(on, 0)
    got = flash_attention_fwd(q, k, v, **kw)
    want = attention_ref(q, k, v, **kw)
    assert flash_attention_fwd.launches_by_variant.get(on, 0) == before + 1, (
        f"not counted as a launch of the {on} route")
    assert not torch.isnan(got).any()
    assert got.dtype == want.dtype and got.shape == want.shape
    atol, rtol = FLASH_TOL[str(dtype)]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    if dtype == torch.bfloat16:
        assert rel_l2(got, want) <= FLASH_BF16_REL_L2


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------

#: the bf16 kernel against the bf16 plain version, which rounds the scores,
#: both products and the state update to bf16 where the kernel keeps f32
SSD_BF16_REL_L2 = 2e-2
#: S of the SSD cases: 2, 3 and 8 chunks through the kernel directly (the
#: state passed across 1, 2 and 7 chunk boundaries; 8 chunks of 256 as on
#: the Mamba path), 2 chunks + 7 through the wrapper, which pads
SSD_LENGTHS = ("2chunks", "3chunks", "8chunks", "2chunks+7")


@pytest.mark.parametrize("at", SSD_LENGTHS)
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("N", [16, 128])
@pytest.mark.parametrize("P", [16, 64])
@pytest.mark.parametrize("chunk", [16, 64, 256])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_ssd_scan_kernel_at_edge_shapes(card, dt, G, chunk, P, N, B, at):
    """The SSD kernel against ``ssd_chunked`` in f32 on the same values
    (``SSD_TOL``; the state to the f32 tolerance), bf16 also against the
    bf16 plain version in relative L2; no NaN, one launch counted."""
    dtype, H = DTYPES[dt], 4
    S = {"2chunks": 2 * chunk, "3chunks": 3 * chunk, "8chunks": 8 * chunk,
         "2chunks+7": 2 * chunk + 7}[at]
    fn = ssd_scan if at == "2chunks+7" else ssd_scan_fwd
    g = torch.Generator(device=card).manual_seed(4)
    x, dt_, A_log, Bm, Cm = _ssd_inputs(g, B, S, H, P, G, N, dtype)
    before = ssd_scan_fwd.launches
    y, st = fn(x, dt_, A_log, Bm, Cm, chunk)
    assert ssd_scan_fwd.launches == before + 1, "not counted as one launch"
    yr, sr = ssd_chunked(x.float(), dt_, A_log, Bm.float(), Cm.float(), chunk)
    assert y.dtype == dtype and tuple(y.shape) == (B, S, H, P)
    assert tuple(st.shape) == (B, H, P, N)
    assert not torch.isnan(y).any()
    atol, rtol = SSD_TOL[str(dtype)]
    torch.testing.assert_close(y.float(), yr, atol=atol, rtol=rtol, msg="y")
    atol, rtol = SSD_TOL[str(torch.float32)]
    torch.testing.assert_close(st, sr, atol=atol, rtol=rtol, msg="state")
    if dtype == torch.bfloat16:
        yb, _ = ssd_chunked(x, dt_, A_log, Bm, Cm, chunk)
        assert rel_l2(y, yb) <= SSD_BF16_REL_L2


# ---------------------------------------------------------------------------
# the MoE router
# ---------------------------------------------------------------------------

#: the router's edge cases: T at one token, a decode tick, a tile's tokens
#: - 1, a tile, a tile + 1 (the first look-back), the prefill's 2048 (8
#: tiles), 2049 (ragged; the wrapper pads it to 2304) and 8192 (32 tiles);
#: E up to the kernel's 128 (Granite's 72 among them), k the top-1 and
#: top-2 instances' and the wide one's (Granite's 10, and the most, 16)
MOE_EDGE_T = (1, 4, 255, 256, 257, 2048, 2049, 8192)
MOE_EDGE_E = (4, 8, 16, 64, 72, 128)
MOE_EDGE_K = (1, 2, 10, 16)
#: the logits: random; rows all equal, tied at the top two, tied below the
#: top, or rounded down to whole numbers; rows holding a NaN, all -inf, or
#: holding a +inf (each such row's probabilities are all NaN)
MOE_KINDS = ("random", "tied", "non-finite")
#: Granite's k = 10 of 72 at more token counts (a decode tick of 7 slots, a
#: prefill of 1000, 4096 and 16,384 tokens), with a capacity that drops, on
#: random logits and on logits of four values (many exact ties)
MOE_K10_T = (1, 7, 256, 257, 1000, 4096, 16384)


def _moe_logits(g, kind, T, E):
    x = torch.randn((T, E), generator=g, device="cuda")
    if kind == "tied":
        x[0::4] = 0.5
        x[1::4, :2] = 3.0
        x[2::4, 1:] = x[2::4, 1:2]
        x[3::8] = torch.floor(x[3::8])
    elif kind == "non-finite":
        x[0::3, E // 2] = float("nan")
        x[1::3] = float("-inf")
        x[2::3, -1] = float("inf")
    elif kind == "four-valued":
        x = torch.randint(0, 4, (T, E), generator=g, device="cuda").float()
    return x


def _moe_cases():
    for E, k, T, drop, kind in itertools.product(MOE_EDGE_E, MOE_EDGE_K, MOE_EDGE_T,
                                                 (False, True), MOE_KINDS):
        if k <= E:
            yield E, k, T, drop, kind
    for T, kind in itertools.product(MOE_K10_T, ("random", "four-valued")):
        if kind != "random" or T not in MOE_EDGE_T:
            yield 72, 10, T, True, kind


@pytest.mark.parametrize("E,k,T,drop,kind", [
    pytest.param(*c, id=f"E{c[0]}-k{c[1]}-T{c[2]}-{'drop' if c[3] else 'keep'}-{c[4]}")
    for c in _moe_cases()])
def test_moe_route_kernel_equals_the_plain_version(card, E, k, T, drop, kind):
    """``moe_route_fwd`` ``BACK_TO_BACK`` times with no synchronize between
    them, then through the wrapper, which pads to 256, against
    ``moe_route_ref``: expert ids, ordinals and keep flags bit for bit
    (rows with a NaN or an infinity rank NaN highest, so their ids are 0
    and 1); weights within ``MOE_W_ATOL``, NaN where the plain version's
    are. A dropping capacity drops something past a decode tick."""
    g = torch.Generator(device=card).manual_seed(5)
    C = max(1, T * k // E // 2) if drop else T * k
    x = _moe_logits(g, kind, T, E)
    want = moe_route_ref(x, k, C)
    outs = _back_to_back(moe_route_fwd, lambda: moe_route_fwd(x, k, C), BACK_TO_BACK + 1,
                         lambda: moe_route(x, k, C))
    for i, got in enumerate(outs):
        call = "the wrapper" if i == BACK_TO_BACK else f"launch {i + 1}"
        for a, b, nm in zip(got[1:], want[1:], ("idx", "pos", "keep")):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f"{call}: {nm}")
        assert torch.equal(got[0].isnan(), want[0].isnan()), f"{call}: NaN weights differ"
        err = max_err(torch.nan_to_num(got[0]), torch.nan_to_num(want[0]))
        assert err <= MOE_W_ATOL, f"{call}: weights max abs err {err}"
    if drop and T > 4:
        assert not bool(want[3].all()), "nothing dropped"
