"""Plain torch version of the bucket-route kernel."""
from __future__ import annotations

import torch


def bucket_route_ref(dest: torch.Tensor, p: int, capacity: int):
    """Capacity ordinals by the stable-argsort formulation (the exact code
    path of core/shuffle._pack_exchange, inverted back to row order).
    dest: (N,) int32 in [0, p]; ``p`` is the padding sentinel, which claims
    no ordinal and adds to no count."""
    n = dest.shape[0]
    d = dest.long()
    order = torch.sort(d, stable=True).indices
    ds = d[order]
    counts_all = torch.bincount(ds, minlength=p + 1)
    starts = torch.cumsum(counts_all, 0) - counts_all
    pos_sorted = torch.arange(n, device=dest.device) - starts[ds]
    pos = torch.empty(n, dtype=torch.int32, device=dest.device)
    pos[order] = pos_sorted.to(torch.int32)
    routed = dest < p
    pos = torch.where(routed, pos, 0)  # the kernel's one-hot of p is empty
    keep = (pos < capacity) & routed
    return pos, keep, counts_all[:p].to(torch.int32)
