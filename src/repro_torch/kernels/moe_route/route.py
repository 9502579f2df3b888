"""Shuffle bucket routing (capacity ordinals) — CUDA C++ kernel for Hopper,
in one pass.

Replaces the Pallas TPU kernel ``src/repro/kernels/moe_route/route.py::
bucket_route_fwd``. There, a sequential grid walked row tiles and a VMEM
``(1, p)`` scratch carried per-destination running counts, so ordinals came
out in row order without an argsort. Here (``src/repro_torch/csrc/
bucket_route.cu``) every block routes one tile and takes the counts of the
tiles before it from a decoupled look-back (``csrc/lookback.cuh``), one
chain per bucket; in the tile, a row's rank comes from its peers in its
warp (a ballot per bit of the bucket id) and its warp's base from a
per-warp table of counts in shared memory, scanned over the warps. One
launch besides the memset of its scratch.

For row r with destination b, ``pos`` is the number of earlier rows routed
to b — the rank a stable argsort by destination assigns — so the packed
exchange buffer is bit-identical to the argsort path. The padding sentinel
``p`` claims no ordinal and adds to no count. The kernel masks its own
ragged tail: the wrapper does not pad.

The shuffle engine routes every source rank in one launch by giving row r
of rank s the composite destination ``s·p + dest`` over ``P = p·p``
buckets: ordinals then count earlier rows of the same rank only.

What bounds it on this card: launch latency — at the hybrid join's 2^20
rows it moves 9 MB, a few µs at the card's memory rate. The wrapper's host
work is one allocation, cut into the three outputs and the scratch.

``block`` selects the threads of a block, rounded to a power of two in
[32, 512]; the block takes fewer warps where their tables (4 bytes a bucket
each, and 4 more for the tile's counts) would pass ``TABLE_BYTES``, and a
tile at least 16 rows a bucket. ``geometry`` decides both, and the wrapper
passes them to the entry point, which takes any tile of whole batches of
rounds for each warp: a tile is where this module says.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import (_cuda, count_launch, counted, fake_call, is_fake, require_cuda,
                                 threads_for)
from repro_torch.kernels.moe_route.ref import bucket_route_ref

#: the most buckets the kernel takes: one warp's table of counts and the
#: tile's counts, 8 bytes a bucket, in 128 KB of shared memory
MAX_BUCKETS = 16 * 1024
#: the warps' tables and the tile's counts in a block, at most, unless one
#: warp's need more
TABLE_BYTES = 48 * 1024
#: a warp walks its rows 32 at a time, loading this many rounds' rows at once
#: (``U`` in the source, which refuses a tile that is not whole batches of
#: them), and takes at least MIN_BATCHES such batches a tile
ROUNDS_AT_ONCE = 8
MIN_BATCHES = 2
#: a tile's rows, at least, per bucket
ROWS_PER_BUCKET = 16
_fn = None


def _entry():
    global _fn
    if _fn is None:
        _fn = _cuda.entry("bucket_route", "bucket_route_fwd",
                          [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                          + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_void_p])
    return _fn


@functools.lru_cache(maxsize=256)
def geometry(p: int, block: int) -> tuple[int, int]:
    """(warps of a block, rows of a tile) for ``p`` buckets at ``block``."""
    warps = max(1, min(threads_for(block) // 32, TABLE_BYTES // (4 * p) - 1))
    batch = 32 * ROUNDS_AT_ONCE * warps
    return warps, batch * max(MIN_BATCHES, -(-ROWS_PER_BUCKET * p // batch))


def scratch_bytes(n: int, p: int, block: int) -> int:
    """The look-back's scratch: a tile counter and one 64-bit word per
    (tile, bucket); none for one tile. The entry point refuses less than its
    own count."""
    tiles = -(-n // geometry(p, block)[1])
    return 8 + 8 * tiles * p if tiles > 1 else 0


def outputs(n: int, p: int, scratch: int, device):
    """(pos i32 (n,), keep bool (n,), counts i32 (p,)) and the int32
    allocation they are views of: pos at byte 0, counts at 4n, keep at
    4n + 4p, then ``scratch`` bytes of the look-back's scratch from 5n + 4p
    rounded up to 8 bytes (offset returned last)."""
    off = -(-(5 * n + 4 * p) // 8) * 8
    base = torch.empty((off + scratch + 3) // 4, dtype=torch.int32, device=device)
    return (base.as_strided((n,), (1,), 0),
            base.view(torch.bool).as_strided((n,), (1,), 4 * n + 4 * p),
            base.as_strided((p,), (1,), n), base, off)


def _check(dest, p):
    """The launch's preconditions (none reads data)."""
    require_cuda(dest)
    if dest.dtype != torch.int32 or dest.ndim != 1:
        raise ValueError(f"bucket_route kernel takes (N,) int32 destinations, "
                         f"got {tuple(dest.shape)} {dest.dtype}")
    if not 1 <= p <= MAX_BUCKETS:
        raise ValueError(f"bucket_route kernel takes 1 <= p <= {MAX_BUCKETS} buckets "
                         f"(one warp's table of counts in 128 KB of shared memory), got {p}")


@counted
def bucket_route_fwd(dest: torch.Tensor, p: int, capacity: int,
                     block: int = 512):
    """dest: (N,) int32 in [0, p] (p = padding sentinel; a row past it
    routes as one to it). Returns (pos (N,)
    i32, keep (N,) bool, counts (p,) i32 — final per-destination demand).
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if is_fake(dest):  # an operation per row
        if dest.is_cuda:  # priced as the card's call: refused where a launch would be
            _check(dest, int(p))
        n, dev = dest.shape[0], dest.device
        return fake_call((dest,), (torch.empty(n, dtype=torch.int32, device=dev),
                                   torch.empty(n, dtype=torch.bool, device=dev),
                                   torch.empty(int(p), dtype=torch.int32, device=dev)), n,
                         "bucket_route")
    if not dest.is_cuda:
        return bucket_route_ref(dest, p, capacity)
    p, capacity = int(p), int(capacity)
    _check(dest, p)
    n = dest.shape[0]
    warps, rows = geometry(p, block)
    nbytes = scratch_bytes(n, p, block)
    pos, keep, counts, buf, off = outputs(n, p, nbytes, dest.device)
    if n == 0:
        counts.zero_()
        return pos, keep, counts
    dev, base = dest.device.index, buf.data_ptr()
    args = (dest.data_ptr(), base, base + 4 * n + 4 * p, base + 4 * n, n, p, capacity,
            warps, rows, base + off, nbytes)
    if dev == torch.cuda.current_device():
        err = _entry()(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = _entry()(*args, torch._C._cuda_getCurrentRawStream(dev))
    _cuda.raise_on_error("bucket_route", err, "bucket_route")
    count_launch(bucket_route_fwd, ((n,), p, capacity))
    return pos, keep, counts
