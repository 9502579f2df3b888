"""Plain torch versions: inclusive segmented scan over sorted-key runs.

Matches core/shuffle.segmented_reduce semantics: invalid rows are their own
segments; output[i] = running reduction of row i's segment up to i.
Identities come from ``op_identity`` (integer-safe), never float ±inf.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.prefix import op_identity

_FNS = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}


def heads_of(keys: torch.Tensor, valid: torch.Tensor, seg: int | None = None):
    """First valid row of every equal-key run. ``seg`` is the rows per rank
    of a flat rank-major layout: every rank's row 0 is a first row too, so
    no run crosses a rank (the reference computes heads per shard)."""
    n = keys.shape[0]
    prev = torch.cat([keys[:1], keys[:-1]])
    idx = torch.arange(n, device=keys.device)
    first = (idx % seg == 0) if seg else (idx == 0)
    pv = torch.cat([valid[:1], valid[:-1]])
    return valid & (first | (keys != prev) | ~pv)


def segment_scan_plain(values: torch.Tensor, boundaries: torch.Tensor,
                       op: str = "sum") -> torch.Tensor:
    """The segment kernel's plain version. values: (N, D) pre-masked;
    boundaries: (N,) bool head-or-invalid flags. Hillis–Steele log-depth
    segmented inclusive scan."""
    fn = _FNS[op]
    v = values
    f = boundaries.clone()
    n = v.shape[0]
    off = 1
    while off < n:
        comb = fn(v[:-off], v[off:])
        keep = f[off:, None]
        v = torch.cat([v[:off], torch.where(keep, v[off:], comb)])
        f = torch.cat([f[:off], f[off:] | f[:-off]])
        off *= 2
    return v


def segment_reduce_ref(keys, valid, values, op: str = "sum", seg: int | None = None):
    """keys: (N,) sorted; valid: (N,) bool; values: (N,) or (N, D).
    Returns (heads (N,), scanned (N, …)) — inclusive segmented scan."""
    heads = heads_of(keys, valid, seg)
    hb = heads | ~valid
    squeeze = values.ndim == 1
    v = values[:, None] if squeeze else values
    ident = torch.as_tensor(op_identity(op, v.dtype), dtype=v.dtype, device=v.device)
    v = torch.where(valid[:, None], v, ident)
    out = segment_scan_plain(v, hb, op)
    return heads, (out[:, 0] if squeeze else out)
