"""Public bucket-route wrapper: sentinel padding, empty input.

The MoE router itself (softmax + top-k + expert ordinals) is not part of
the port yet; this package holds the shuffle exchange's router, which reuses
its capacity-ordinal technique.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_route.route import bucket_route_fwd


def bucket_route(dest: torch.Tensor, p: int, capacity: int, block: int = 512):
    """Shuffle-exchange routing: capacity ordinals in row order.

    dest: (N,) int32 in [0, p). Returns (pos (N,) i32, keep (N,) bool,
    counts (p,) i32) — bit-identical to the stable-argsort formulation in
    core/shuffle._pack_exchange (and to ``bucket_route_ref``). The tensor's
    device picks kernel or plain version."""
    (N,) = dest.shape
    dev = dest.device
    if N == 0:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev),
                torch.zeros(p, dtype=torch.int32, device=dev))
    d = dest.to(torch.int32)
    pad = (-N) % block if N > block else 0
    if pad:
        # the sentinel p one-hots to an all-zero row: padding neither
        # claims ordinals nor inflates counts
        d = torch.cat([d, d.new_full((pad,), p)])
    pos, keep, counts = bucket_route_fwd(d.contiguous(), p=p, capacity=capacity,
                                         block=block)
    return pos[:N], keep[:N], counts
