"""Sorted segmented reduction (inclusive segmented scan) — Triton kernel
for Hopper.

Replaces the Pallas TPU kernel ``src/repro/kernels/segment_reduce/
segment_reduce.py::segment_reduce_fwd``. There, a sequential grid walked the
row tiles and a VMEM scratch row carried the running segment value from one
tile into the next. CUDA blocks run in parallel and in no order, so the
carry becomes a second pass:

  1. ``seg_tile``: each program scans ``BLOCK`` rows of ``(value, flag)``
     pairs with ``tl.associative_scan`` under the segmented combine
     ``(f_b ? v_b : op(v_a, v_b), f_a | f_b)`` — the combine of the
     reference's ``segment_reduce/ref.py`` — and stores the rows plus the
     tile's aggregate (its last running value, and whether it holds a
     boundary);
  2. the aggregates are scanned by the same scheme, recursively, which
     gives the running value at the end of every tile;
  3. ``seg_fold``: every tile after the first folds the running value at
     the end of the tile before it into its rows that come before the
     tile's first boundary (the reference's ``seen`` mask).

Boundaries are head-or-invalid flags, so an invalid row never takes a
carry, and the wrapper marks every rank's first row, so no segment crosses
a rank of the flat rank-major layout.

What bounds it on this card: bytes — one combine per element, far below the
operations-per-byte balance of the H100. The least traffic reads values and
flags once and writes values once; pass 3 re-reads flags and values and
re-writes values (about 2x the least bytes), which buys the parallel carry
without inter-block synchronisation.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (count_launch, counted, next_pow2, require_cuda,
                                 tile, triton_kernels)
from repro_torch.kernels.segment_reduce.ref import segment_scan_plain
from repro_torch.kernels.ssd_scan.prefix import op_identity

_OPS = {"sum": 0, "max": 1, "min": 2}


def _scan_cuda(v: torch.Tensor, flags: torch.Tensor, op: str,
               block: int) -> torch.Tensor:
    """v: (N, D) contiguous; flags: (N,) uint8 boundaries."""
    K = triton_kernels("repro_torch.kernels.segment_reduce._triton")
    n, d = v.shape
    bq = tile(block, n)
    dp = next_pow2(d)
    n_tiles = -(-n // bq)
    ident = op_identity(op, v.dtype)
    if v.dtype.is_floating_point:
        ident = float(ident)
    out = torch.empty_like(v)
    aggv = torch.empty((n_tiles, d), dtype=v.dtype, device=v.device)
    aggf = torch.empty((n_tiles,), dtype=torch.uint8, device=v.device)
    meta = dict(D=d, DP=dp, OP=_OPS[op], BLOCK=bq)
    K.seg_tile[(n_tiles,)](v, flags, out, aggv, aggf, n, ident, **meta)
    if n_tiles > 1:
        inc = _scan_cuda(aggv, aggf, op, block)
        K.seg_fold[(n_tiles - 1,)](out, flags, inc, n, **meta)
    return out


@counted
def segment_reduce_fwd(values: torch.Tensor, boundaries: torch.Tensor,
                       op: str = "sum", block: int = 256) -> torch.Tensor:
    """values: (N, D) pre-masked on invalid rows; boundaries: (N,) bool =
    head-or-invalid flags. Returns the inclusive segmented scan (N, D),
    values.dtype. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel."""
    if op not in _OPS:
        raise ValueError(f"segment scan op must be sum/max/min, got {op!r}")
    if not values.is_cuda:
        return segment_scan_plain(values, boundaries, op)
    require_cuda(values, boundaries)
    if (values.dtype not in (torch.int32, torch.float32) or values.ndim != 2
            or boundaries.dtype != torch.bool
            or boundaries.shape != values.shape[:1]):
        raise ValueError(
            f"segment_reduce kernel takes (N, D) int32/float32 values and (N,) "
            f"bool boundaries, got {tuple(values.shape)} {values.dtype} and "
            f"{tuple(boundaries.shape)} {boundaries.dtype}")
    count_launch(segment_reduce_fwd, (tuple(values.shape), op))
    return _scan_cuda(values, boundaries.view(torch.uint8), op, block)
