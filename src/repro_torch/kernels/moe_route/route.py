"""Shuffle bucket routing (capacity ordinals) — Triton kernel for Hopper.

Replaces the Pallas TPU kernel ``src/repro/kernels/moe_route/route.py::
bucket_route_fwd``. There, a sequential grid walked row tiles and a VMEM
``(1, p)`` scratch carried per-destination running counts, so ordinals came
out in row order without an argsort. CUDA blocks run in parallel and in no
order, so the carried counts become a scan between two passes:

  1. ``tile_hist``: a per-tile histogram ``(n_tiles, P)`` of destinations;
  2. ``col_scan``: one program per destination scans its column down the
     tiles — the exclusive prefix is each tile's base, the total is
     ``counts``;
  3. ``tile_rank``: each row's stable rank inside its tile, from a one-hot
     ``(BLOCK, P_PAD)`` ``tl.cumsum`` (the construction of the reference's
     ``route.py``), plus the tile's base. ``keep = pos < C & dest < P``.

For row r with destination b, ``pos`` is the number of earlier rows routed
to b — the rank a stable argsort by destination assigns — so the packed
exchange buffer is bit-identical to the argsort path. The padding sentinel
``P`` one-hots to nothing: it claims no ordinal and adds to no count.

The shuffle engine routes every source rank in one launch by giving row r
of rank s the composite destination ``s·p + dest`` over ``P = p·p``
buckets: ordinals then count earlier rows of the same rank only.

What bounds it on this card: bytes. Per row it reads 4 bytes twice (passes
1 and 3) and writes 5 (pos, keep); the histogram and bases are
``n_tiles·P`` words. The one-hot costs ``P_PAD`` operations per row in
registers, still under the card's operations-per-byte balance at P = 64.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (count_launch, counted, next_pow2, require_cuda,
                                 tile, triton_kernels)
from repro_torch.kernels.moe_route.ref import bucket_route_ref



def _route_cuda(dest: torch.Tensor, p: int, capacity: int, block: int):
    K = triton_kernels("repro_torch.kernels.moe_route._triton")
    n = dest.shape[0]
    bt = tile(block, n)
    pp = next_pow2(p)
    n_tiles = -(-n // bt)
    dev = dest.device
    hist = torch.empty((n_tiles, p), dtype=torch.int32, device=dev)
    base = torch.empty((n_tiles, p), dtype=torch.int32, device=dev)
    counts = torch.empty((p,), dtype=torch.int32, device=dev)
    pos = torch.empty((n,), dtype=torch.int32, device=dev)
    keep = torch.empty((n,), dtype=torch.uint8, device=dev)
    K.tile_hist[(n_tiles,)](dest, hist, n, P=p, PP=pp, BLOCK=bt)
    K.col_scan[(p,)](hist, base, counts, n_tiles, P=p, CHUNK=1024)
    K.tile_rank[(n_tiles,)](dest, base, pos, keep, n, capacity, P=p, PP=pp,
                           BLOCK=bt)
    return pos, keep.view(torch.bool), counts


@counted
def bucket_route_fwd(dest: torch.Tensor, p: int, capacity: int,
                     block: int = 512):
    """dest: (N,) int32 in [0, p] (p = padding sentinel). Returns (pos (N,)
    i32, keep (N,) bool, counts (p,) i32 — final per-destination demand).
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel."""
    if not dest.is_cuda:
        return bucket_route_ref(dest, p, capacity)
    require_cuda(dest)
    if dest.dtype != torch.int32 or dest.ndim != 1:
        raise ValueError(f"bucket_route kernel takes (N,) int32 destinations, "
                         f"got {tuple(dest.shape)} {dest.dtype}")
    count_launch(bucket_route_fwd, (tuple(dest.shape), int(p), int(capacity)))
    return _route_cuda(dest, int(p), int(capacity), block)
