"""Inclusive 1-D prefix scan (sum/max/min) — Triton kernel for Hopper.

Replaces the Pallas TPU kernel ``src/repro/kernels/ssd_scan/prefix.py::
prefix_scan_fwd``, whose sequential grid carried the running reduction from
tile to tile in a VMEM scratch scalar. CUDA blocks run in parallel and in no
order, so the carry becomes a second pass:

  1. ``scan_tile``: each program scans ``BLOCK`` rows with
     ``tl.associative_scan`` and stores the rows plus the tile's aggregate;
  2. the aggregates (``n/BLOCK`` of them) are scanned by the same two-pass
     scheme, recursively, until one tile holds them all;
  3. ``fold_carry``: every tile after the first folds the inclusive
     aggregate of the tiles before it into its rows.

What bounds it on this card: bytes. It does one add/min/max per element,
far below the H100's ~295 operations per byte of device memory. The least
traffic is one read and one write per element; this version reads and
writes the output a second time in pass 3 (about 2x the least bytes) in
exchange for needing no inter-block synchronisation. A single-pass
decoupled look-back would reach the least bytes.

``segment_totals`` runs it with ``reverse=True`` (the wrapper flips) as the
suffix-min that finds each key segment's last row.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import count_launch, counted, require_cuda, tile, triton_kernels
from repro_torch.kernels.ssd_scan.ref import prefix_scan_ref

_OPS = {"sum": 0, "max": 1, "min": 2}


def op_identity(op: str, dtype):
    """True identity of ``op`` on ``dtype`` (python scalar)."""
    if op == "sum":
        return 0
    if dtype.is_floating_point:
        return float("-inf") if op == "max" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if op == "max" else info.max


def _scan_cuda(x: torch.Tensor, op: str, block: int) -> torch.Tensor:
    K = triton_kernels("repro_torch.kernels.ssd_scan._triton")
    n = x.shape[0]
    bq = tile(block, n)
    n_tiles = -(-n // bq)
    ident = op_identity(op, x.dtype)
    if x.dtype.is_floating_point:
        ident = float(ident)
    out = torch.empty_like(x)
    agg = torch.empty((n_tiles,), dtype=x.dtype, device=x.device)
    K.scan_tile[(n_tiles,)](x, out, agg, n, ident, OP=_OPS[op], BLOCK=bq)
    if n_tiles > 1:
        inc = _scan_cuda(agg, op, block)
        K.fold_carry[(n_tiles - 1,)](out, inc, n, OP=_OPS[op], BLOCK=bq)
    return out


@counted
def prefix_scan_fwd(x: torch.Tensor, op: str = "sum",
                    block: int = 512) -> torch.Tensor:
    """x: (N,) int32 or float32. Returns the inclusive scan (N,), same
    dtype. A CPU tensor takes the plain version (the counterpart of Pallas's
    interpret mode); a CUDA tensor launches the kernel."""
    if op not in _OPS:
        raise ValueError(f"prefix scan op must be sum/max/min, got {op!r}")
    if not x.is_cuda:
        return prefix_scan_ref(x, op)
    require_cuda(x)
    if x.dtype not in (torch.int32, torch.float32) or x.ndim != 1:
        raise ValueError(f"prefix_scan kernel takes (N,) int32/float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    count_launch(prefix_scan_fwd, (tuple(x.shape), op))
    return _scan_cuda(x, op, block)
