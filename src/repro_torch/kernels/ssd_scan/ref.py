"""Plain torch versions of the SSD scan kernel (= the model-side chunked
SSD) and of the prefix-scan kernel (= torch's cumulative ops)."""
from __future__ import annotations

import torch

from repro_torch.models.mamba2 import ssd_chunked


def ssd_ref(x, dt, A_log, Bm, Cm, chunk):
    """x: (b, s, h, p); dt: (b, s, h) (softplus applied); A_log: (h,);
    Bm/Cm: (b, s, g, n). Returns (y, final_state)."""
    return ssd_chunked(x, dt, A_log, Bm, Cm, chunk)


def _cum(v: torch.Tensor, op: str) -> torch.Tensor:
    if op == "sum":
        return torch.cumsum(v, dim=0, dtype=v.dtype)
    if op == "max":
        return torch.cummax(v, dim=0).values
    if op == "min":
        return torch.cummin(v, dim=0).values
    raise ValueError(f"prefix scan op must be sum/max/min, got {op!r}")


def prefix_scan_ref(x: torch.Tensor, op: str = "sum", reverse: bool = False):
    """Inclusive scan; ``reverse=True`` scans from the tail (suffix scan).
    Bool rides as i32 and is cast back."""
    v = x.to(torch.int32) if x.dtype == torch.bool else x
    if reverse:
        v = torch.flip(v, dims=(0,))
    out = _cum(v, op)
    if reverse:
        out = torch.flip(out, dims=(0,))
    return out.to(torch.bool) if x.dtype == torch.bool else out
