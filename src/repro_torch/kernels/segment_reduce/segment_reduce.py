"""Sorted segmented reduction (inclusive segmented scan) — CUDA C++ kernel
for Hopper, in one pass.

Replaces the Pallas TPU kernel ``src/repro/kernels/segment_reduce/
segment_reduce.py::segment_reduce_fwd``. There, a sequential grid walked the
row tiles and a VMEM scratch row carried the running segment value from one
tile into the next. Here (``src/repro_torch/csrc/segment_reduce.cu``) every
block scans one tile of rows under the segmented combine
``(f_b ? v_b : op(v_a, v_b), f_a | f_b)`` — the combine of ``ref.py`` — and
takes the value carried into the tile from a decoupled look-back
(``csrc/lookback.cuh``) over its predecessors' aggregates, which stops at
the first that holds a boundary. Values and flags are read once and the
scan written once, in one launch besides the memset of its scratch.

``block`` selects the threads of a block, rounded to a power of two in
[32, 512]; each thread scans 16 consecutive rows (D = 1) or 4 rows of a
group of 4 columns (D > 1), so a tile is 16·block rows (or 4·block rows of
4 columns). The registry's autotune sweeps it (``ignis.kernels.blocks``).

Boundaries are head-or-invalid flags, so an invalid row never takes a
carry, and the wrapper marks every rank's first row, so no segment crosses
a rank of the flat rank-major layout. The kernel masks its own ragged tail:
the wrapper does not pad.

What bounds it on this card: bytes — one combine per element, far below the
operations-per-byte balance of the H100.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (_cuda, count_launch, counted, fake_call, is_fake, require_cuda,
                                 threads_for)
from repro_torch.kernels.segment_reduce.ref import segment_scan_plain

_OPS = {"sum": 0, "max": 1, "min": 2}
_DTYPES = {torch.int32: 0, torch.float32: 1}
_fn = None


def _entry():
    global _fn
    if _fn is None:
        _fn = _cuda.entry("segment_reduce", "segment_reduce_fwd",
                          [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                          + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])
    return _fn


def rows_per_tile(d: int, block: int) -> int:
    """Rows of a tile at ``d`` columns and ``block`` (``R1`` and ``RD`` rows
    a thread in the source)."""
    return threads_for(block) * (16 if d == 1 else 4)


def scratch_bytes(n: int, d: int, block: int) -> int:
    """The look-back's scratch: a tile counter, then one 64-bit word per
    tile and column of a group (1 column at D = 1, else groups of 4); the
    entry point refuses less than its own count."""
    cols = 1 if d == 1 else 4
    tiles = -(-n // rows_per_tile(d, block))
    return 8 + 8 * tiles * -(-d // cols) * cols


def _scan_cuda(v: torch.Tensor, flags: torch.Tensor, op: str, block: int) -> torch.Tensor:
    """v: (N, D) contiguous; flags: (N,) uint8 boundaries."""
    n, d = v.shape
    nbytes = scratch_bytes(n, d, block)
    out = torch.empty_like(v)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=v.device)
    with torch.cuda.device(v.device):
        err = _entry()(v.data_ptr(), flags.data_ptr(), out.data_ptr(), n, d, _DTYPES[v.dtype],
                       _OPS[op], threads_for(block), scratch.data_ptr(), nbytes,
                       torch.cuda.current_stream(v.device).cuda_stream)
    _cuda.raise_on_error("segment_reduce", err, "segment_reduce")
    return out


def _check(values, boundaries):
    """The launch's preconditions (none reads data)."""
    require_cuda(values, boundaries)
    if (values.dtype not in _DTYPES or values.ndim != 2
            or boundaries.dtype != torch.bool
            or boundaries.shape != values.shape[:1]):
        raise ValueError(
            f"segment_reduce kernel takes (N, D) int32/float32 values and (N,) "
            f"bool boundaries, got {tuple(values.shape)} {values.dtype} and "
            f"{tuple(boundaries.shape)} {boundaries.dtype}")


@counted
def segment_reduce_fwd(values: torch.Tensor, boundaries: torch.Tensor,
                       op: str = "sum", block: int = 256) -> torch.Tensor:
    """values: (N, D) pre-masked on invalid rows; boundaries: (N,) bool =
    head-or-invalid flags. Returns the inclusive segmented scan (N, D),
    values.dtype. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    if op not in _OPS:
        raise ValueError(f"segment scan op must be sum/max/min, got {op!r}")
    if is_fake(values):  # a combine per element
        if values.is_cuda:  # priced as the card's call: refused where a launch would be
            _check(values, boundaries)
        return fake_call((values, boundaries), (torch.empty_like(values),), values.numel(),
                         "segment_reduce")[0]
    if not values.is_cuda:
        return segment_scan_plain(values, boundaries, op)
    _check(values, boundaries)
    if values.numel() == 0:
        return torch.empty_like(values)
    out = _scan_cuda(values, boundaries.view(torch.uint8), op, block)
    count_launch(segment_reduce_fwd, (tuple(values.shape), op))
    return out
