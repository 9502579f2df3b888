"""Inclusive 1-D prefix scan (sum/max/min) — CUDA C++ kernel for Hopper, in
one pass.

Replaces the Pallas TPU kernel ``src/repro/kernels/ssd_scan/prefix.py::
prefix_scan_fwd``, whose sequential grid carried the running reduction from
tile to tile in a VMEM scratch scalar. Here it is the segmented scan's tile
scan with the flags compiled out (``prefix_scan_fwd`` in
``src/repro_torch/csrc/segment_reduce.cu``): every block scans one tile and
takes the value carried into it from a decoupled look-back
(``csrc/lookback.cuh``) over its predecessors' aggregates. The input is
read once and the scan written once, in one launch besides the memset of
its scratch.

What bounds it on this card: bytes — one combine per element, far below the
H100's operations-per-byte balance; the least traffic is one read and one
write of each element, which the design moves.

``reverse`` scans from the tail inside the kernel (``segment_totals`` runs
it so, as the suffix-min that finds each key segment's last row), and the
kernel masks its own ragged tail: nothing flips or pads. Max and min take
torch.cummax's and cummin's rule, NaN included, so a CUDA result equals the
plain version's bit for bit; integer sums wrap as torch's do.

``block`` selects the threads of a block, rounded to a power of two in
[32, 512], each scanning 16 rows, as for the segmented scan: the
registry's autotune passes ``segment_totals``' tuned block through. The
wrapper gives the entry point the tile's rows (``rows_per_tile``), from
which it takes its threads, so a tile is where this module says.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (_cuda, count_launch, counted, fake_call, is_fake, require_cuda,
                                 threads_for)
from repro_torch.kernels.ssd_scan.ref import prefix_scan_ref

_OPS = {"sum": 0, "max": 1, "min": 2}
_DTYPES = {torch.int32: 0, torch.float32: 1}
#: rows a thread scans (``R1`` in the source, which refuses a tile that is
#: not whole threads of them, each block's threads in [32, 512])
ROWS_PER_THREAD = 16
_fn = None


def _entry():
    global _fn
    if _fn is None:
        _fn = _cuda.entry("segment_reduce", "prefix_scan_fwd",
                          [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                          + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])
    return _fn


def op_identity(op: str, dtype):
    """True identity of ``op`` on ``dtype`` (python scalar)."""
    if op == "sum":
        return 0
    if dtype.is_floating_point:
        return float("-inf") if op == "max" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if op == "max" else info.max


def rows_per_tile(block: int) -> int:
    """Rows of a tile at ``block``."""
    return threads_for(block) * ROWS_PER_THREAD


def scratch_bytes(n: int, block: int) -> int:
    """The look-back's scratch: a tile counter, then one 64-bit word per
    tile; the entry point refuses less than its own count."""
    return 8 + 8 * -(-n // rows_per_tile(block))


def _check(x):
    """The launch's preconditions (none reads data)."""
    require_cuda(x)
    if x.dtype not in _DTYPES or x.ndim != 1:
        raise ValueError(f"prefix_scan kernel takes (N,) int32/float32, got "
                         f"{tuple(x.shape)} {x.dtype}")


@counted
def prefix_scan_fwd(x: torch.Tensor, op: str = "sum", block: int = 512,
                    reverse: bool = False) -> torch.Tensor:
    """x: (N,) int32 or float32. Returns the inclusive scan (N,), same
    dtype, from the tail where ``reverse``. A CPU tensor takes the plain
    version (the counterpart of Pallas's interpret mode); a CUDA tensor
    launches the kernel or raises."""
    if op not in _OPS:
        raise ValueError(f"prefix scan op must be sum/max/min, got {op!r}")
    if is_fake(x):  # a combine per element
        if x.is_cuda:  # priced as the card's call: refused where a launch would be
            _check(x)
        return fake_call((x,), (torch.empty_like(x),), x.numel(), "prefix_scan")[0]
    if not x.is_cuda:
        return prefix_scan_ref(x, op, reverse)
    _check(x)
    n = x.shape[0]
    out = torch.empty_like(x)
    if n == 0:
        return out
    nbytes = scratch_bytes(n, block)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        err = _entry()(x.data_ptr(), out.data_ptr(), n, _DTYPES[x.dtype], _OPS[op],
                       int(bool(reverse)), rows_per_tile(block), scratch.data_ptr(), nbytes,
                       torch.cuda.current_stream(x.device).cuda_stream)
    _cuda.raise_on_error("segment_reduce", err, "prefix_scan")
    count_launch(prefix_scan_fwd, (tuple(x.shape), op, bool(reverse)))
    return out
