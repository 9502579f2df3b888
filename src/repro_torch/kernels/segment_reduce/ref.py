"""Plain torch versions: inclusive segmented scan over sorted-key runs.

Matches core/shuffle.segmented_reduce semantics: invalid rows are their own
segments; output[i] = running reduction of row i's segment up to i.
Identities come from ``op_identity`` (integer-safe), never float ±inf.
``segment_scan_lookback`` mirrors the CUDA kernel's one-pass dataflow.
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


def segment_scan_lookback(values: torch.Tensor, boundaries: torch.Tensor,
                          op: str = "sum", tile: int = 4096) -> torch.Tensor:
    """The CUDA kernel's dataflow (``csrc/segment_reduce.cu``) in plain
    torch, with ``tile`` rows per tile: each tile's own segmented scan, its
    aggregate (the scan's last row) and whether it holds a boundary; then
    each tile's exclusive prefix from the walk back over the aggregates of
    the tiles before it, which stops at the first that holds a boundary
    (under the segmented combine such an aggregate is its own inclusive
    prefix) or at the first tile; then the tile's rows before its first
    boundary combined with that prefix. The walk never meets a published
    inclusive prefix here, as if no tile before had finished: the longest
    walk the kernel can take. Same arguments and result as
    ``segment_scan_plain``. Nothing on the main path calls it: the tests hold
    the dataflow against the JAX kernel with it, on the CPU, where the CUDA
    kernel cannot run."""
    fn = _FNS[op]
    n = values.shape[0]
    starts = range(0, n, tile)
    scans = [segment_scan_plain(values[a:a + tile], boundaries[a:a + tile], op) for a in starts]
    aggs = [(sc[-1], bool(boundaries[a:a + tile].any())) for a, sc in zip(starts, scans)]
    out = [scans[0]] if scans else [values.clone()]
    for t in range(1, len(scans)):
        pre = None
        for i in range(t - 1, -1, -1):
            v, f = aggs[i]
            pre = v if pre is None else fn(v, pre)
            if f:
                break
        b = boundaries[starts[t]:starts[t] + tile]
        before = (torch.cumsum(b.to(torch.int32), 0) == 0)[:, None]
        out.append(torch.where(before, fn(pre, scans[t]), scans[t]))
    return torch.cat(out)


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
