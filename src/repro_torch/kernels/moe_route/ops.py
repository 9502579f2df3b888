"""Public routing wrappers: the MoE router (``moe_route``: padding) and
the shuffle exchange's router (``bucket_route``: empty input), which
reuses the MoE router's capacity-ordinal technique. The tensors' device
picks kernel or plain version.

``moe_route`` is differentiable in its weights, as the JAX ``route`` is
through ``lax.top_k``'s values: its ``torch.autograd.Function`` returns the
kernel's ``(w, idx, pos, keep)`` (``idx``, ``pos`` and ``keep`` are not
differentiable), and its backward is the vjp of the plain weights
``softmax(logits).gather(1, idx) / max(sum, 1e-9)`` at the chosen experts.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_route.moe_route import moe_route_fwd
from repro_torch.kernels.moe_route.route import bucket_route_fwd


def route_weights(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The router's renormalised top-k weights at experts ``idx`` (T, k), as
    a differentiable function of ``logits`` (T, E): the JAX ``route``."""
    w = torch.softmax(logits.float(), dim=-1).gather(1, idx.long())
    return w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)


class _Route(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, k, capacity):
        w, idx, pos, keep = moe_route_fwd(logits, k, capacity)
        ctx.mark_non_differentiable(idx, pos, keep)
        ctx.save_for_backward(logits, idx)
        return w, idx, pos, keep

    @staticmethod
    def backward(ctx, gw, *_):
        logits, idx = ctx.saved_tensors
        logits = logits.detach().requires_grad_()
        with torch.enable_grad():
            w = route_weights(logits, idx)
        return torch.autograd.grad(w, logits, gw)[0], None, None


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
        return _Route.apply(x, k, capacity)
    x = torch.cat([x, x.new_full((pad, E), -1e9)])
    w, idx, pos, keep = _Route.apply(x, k, capacity)
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
