"""Public routing wrappers: the MoE router (``moe_route``: padding) and
the shuffle exchange's router (``bucket_route``: empty input), which
reuses the MoE router's capacity-ordinal technique. The tensors' device
picks kernel or plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_route.moe_route import moe_route_fwd
from repro_torch.kernels.moe_route.route import bucket_route_fwd


def moe_route(logits: torch.Tensor, k: int, capacity: int, block_t: int = 256):
    """logits: (T, E). Returns (weights f32, idx i32, pos i32, keep bool),
    each (T, k). Tokens are padded to a multiple of ``block_t`` with -1e9
    logits, as the JAX wrapper pads: the padding comes after every real
    token, so it claims no ordinal before them, and it is sliced off."""
    T, E = logits.shape
    pad = (-T) % block_t if T > block_t else 0
    x = logits
    if x.is_cuda:
        x = x.float().contiguous()
    if not pad:  # nothing to cut off: the kernel's outputs as they are
        return moe_route_fwd(x, k, capacity)
    x = torch.cat([x, x.new_full((pad, E), -1e9)])
    w, idx, pos, keep = moe_route_fwd(x, k, capacity)
    return w[:T], idx[:T], pos[:T], keep[:T]


def bucket_route(dest: torch.Tensor, p: int, capacity: int, block: int = 512):
    """Shuffle-exchange routing: capacity ordinals in row order.

    dest: (N,) int32 in [0, p). Returns (pos (N,) i32, keep (N,) bool,
    counts (p,) i32) — bit-identical to the stable-argsort formulation in
    core/shuffle._pack_exchange (and to ``bucket_route_ref``). The tensor's
    device picks kernel or plain version; the kernel masks its ragged tail
    itself, so nothing is padded."""
    (N,) = dest.shape
    dev = dest.device
    if N == 0:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev),
                torch.zeros(p, dtype=torch.int32, device=dev))
    d = dest.to(torch.int32)
    return bucket_route_fwd(d.contiguous(), p=p, capacity=capacity, block=block)
