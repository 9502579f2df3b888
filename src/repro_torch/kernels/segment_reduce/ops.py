"""Public segment_reduce wrappers: masking, the flat rank-major layout.

``segment_reduce`` is the standalone inclusive-scan entry (kernel tests);
``segment_totals`` is the shuffle-stage ABI: the drop-in kernel version of
core/shuffle.segmented_reduce, combining the segment scan with the prefix
kernel's suffix-min for the last-row gather.

Both take ``seg``, the rows per rank of a flat ``(p·seg,)`` layout: heads
mark every rank's row 0 as first, so one launch serves every rank and no
segment — nor the last-row gather — crosses a rank.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.segment_reduce.ref import heads_of
from repro_torch.kernels.segment_reduce.segment_reduce import segment_reduce_fwd
from repro_torch.kernels.ssd_scan.ops import prefix_scan
from repro_torch.kernels.ssd_scan.prefix import op_identity


def _compute_dtype(dtype):
    """f32 for floats, i32 for ints/bool — the kernel's native dtypes."""
    return torch.float32 if dtype.is_floating_point else torch.int32


def _scan(keys, valid, values, op, mask_value, block, seg):
    """Shared core: mask invalid rows to ``mask_value`` and run the
    segmented-scan kernel (which masks its own ragged tail: no padding).
    Returns (heads, scanned (N, D) in the compute dtype, squeeze)."""
    squeeze = values.ndim == 1
    v = values[:, None] if squeeze else values
    ct = _compute_dtype(v.dtype)
    heads = heads_of(keys, valid, seg)
    hb = heads | ~valid
    mv = torch.as_tensor(mask_value, device=v.device).to(ct)
    v = torch.where(valid[:, None], v.to(ct), mv)

    out = segment_reduce_fwd(v.contiguous(), hb.contiguous(), op=op, block=block)
    return heads, out, squeeze


def segment_reduce(keys, valid, values, op: str = "sum", block: int = 256,
                   seg: int | None = None):
    """Inclusive segmented scan over sorted-key runs.

    keys: (N,) sorted (per rank); valid: (N,); values: (N,) or (N, D).
    Returns (heads (N,), scanned (N, …)); float inputs compute in f32,
    integer/bool inputs exactly in i32. The tensors' device picks kernel or
    plain version."""
    ct = _compute_dtype(values.dtype)
    heads, out, squeeze = _scan(keys, valid, values, op, op_identity(op, ct),
                                block, seg)
    return heads, (out[:, 0] if squeeze else out)


def segment_totals(keys, valid, values, op: str, identity, block: int = 256,
                   seg: int | None = None):
    """Shuffle-stage ABI: per-segment totals broadcast to every row.

    Drop-in for core/shuffle.segmented_reduce with a builtin fn: invalid
    rows are masked to the *user* identity (the identity never enters a
    combine, invalid rows are their own boundaries), the segment scan runs
    in the kernel, and the last-row gather uses the prefix kernel's reverse
    cummin. Bit-identical to the plain path for associative-exact data
    (integers; max/min on any dtype).

    Returns (heads (N,) bool, totals (N, …) in values.dtype).
    """
    n = keys.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=keys.device), values
    heads, scanned, squeeze = _scan(keys, valid, values, op, identity, block, seg)
    hb = heads | ~valid
    # last row of each segment = (next boundary) - 1, via the suffix-min
    # prefix pass (core/shuffle.segmented_reduce's exact formula)
    idx = torch.arange(n, device=keys.device, dtype=torch.int32)
    head_pos = torch.where(hb, idx, torch.full_like(idx, n))
    suff_min = prefix_scan(head_pos, op="min", block=block, reverse=True)
    nxt = torch.cat([suff_min[1:], suff_min.new_full((1,), n)])
    last_pos = torch.clamp(torch.where(nxt >= n, n - 1, nxt - 1), 0, n - 1)
    out = scanned[last_pos.long()].to(values.dtype)
    return heads, (out[:, 0] if squeeze else out)
