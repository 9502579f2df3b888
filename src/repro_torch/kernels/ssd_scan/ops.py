"""Public prefix-scan wrapper: bool as i32, reversal, identity padding.

``prefix_scan`` is the shuffle engine's prefix pass (the reference hosts it
beside the SSD scan because the Pallas kernel reuses the SSD carry
pattern). The SSD scan itself is not part of the port yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.prefix import op_identity, prefix_scan_fwd


def prefix_scan(x: torch.Tensor, op: str = "sum", block: int = 512,
                reverse: bool = False) -> torch.Tensor:
    """Inclusive prefix scan (sum/max/min) over a 1-D tensor.

    ``reverse=True`` scans from the tail (the suffix-min pass of
    ``segment_totals``). Bool rides as i32 and is cast back. Bit-identical
    to ``prefix_scan_ref`` for integer dtypes (associative-exact ops — any
    association order agrees). The tensor's device picks kernel or plain
    version."""
    (N,) = x.shape
    if N == 0:
        return x
    squeeze_bool = x.dtype == torch.bool
    v = x.to(torch.int32) if squeeze_bool else x
    if reverse:
        v = torch.flip(v, dims=(0,))
    ident = op_identity(op, v.dtype)
    pad = (-N) % block if N > block else 0
    if pad:
        v = torch.cat([v, v.new_full((pad,), ident)])
    out = prefix_scan_fwd(v.contiguous(), op=op, block=block)[:N]
    if reverse:
        out = torch.flip(out, dims=(0,))
    return out.to(torch.bool) if squeeze_bool else out
