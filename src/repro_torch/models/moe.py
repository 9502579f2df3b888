"""Mixture-of-Experts FFN with sort-free capacity dispatch (the port of
``repro.models.moe``).

The router's softmax, top-k, renormalisation and per-expert capacity
ordinals come from the router kernel (``repro_torch.kernels.moe_route``:
CUDA on the card, its plain version on the CPU), where the JAX function
computes them with ``lax.top_k`` and a stable argsort; both give each
assignment its rank within its expert in token-major, slot-minor order.
Under grad the router's weights differentiate as the JAX function's do
through ``lax.top_k``'s values: the kernel's ``autograd.Function`` takes
the vjp of the plain renormalised softmax at the chosen experts.
Tokens are then packed into an (E, capacity, D) buffer with capacity
dropping, run through batched per-expert SwiGLU products, and scattered back
with their router weights. The load-balancing auxiliary loss follows
Switch/ST-MoE. The router product ``x @ router``, the packing, the expert
products, the scatter and the loss stay plain torch, as they are plain jnp
outside any kernel in the JAX package.

Under ``cfg.moe_dropless`` (granite) no assignment is dropped:
``moe_ffn_dropless`` sorts the assignments by expert without a sort (the
router's ordinals plus each expert's offset, from the counts of the
experts before it, give each its row), gathers their tokens into one
(T·k, D) buffer, and runs the experts' products as grouped products over
the experts' segments of it (``kernels.moe_experts``), so the expert work
grows with the assignments and not with E x T; each token's k outputs are
summed with their router weights in f32. The buffer's row offsets stay on
the device: nothing is read back. A config's ``moe_shared_ff`` adds a
shared SwiGLU expert (``MoE.shared``) that every token takes, on either
path.

Expert parallelism is ``models/moe_ep.py``: ``moe_apply`` takes it by an
explicit rule (``moe_ep.ep_applicable``: ``cfg.moe_ep``, an ambient mesh
whose data axis has p > 1 ranks, ``E % p == 0``, ``B % p == 0``) where the
JAX function tries EP and falls back from any error to the flat path; an
error inside the port's EP raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.moe_experts import grouped_experts
from repro_torch.models.layers import MLP, mlp, weight
from repro_torch.profile.spans import span


class MoE(nn.Module):
    """``router`` (D, E) f32; ``w_gate``, ``w_up`` (E, D, F) and ``w_down``
    (E, F, D) in the parameter dtype — the JAX package's ``make_moe_params``;
    with ``cfg.moe_shared_ff``, ``shared``: the shared expert's SwiGLU."""

    def __init__(self, cfg, dtype, device=None, generator=None):
        super().__init__()
        E, D, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff
        self.router = weight((D, E), torch.float32, device, generator)
        self.w_gate = weight((E, D, Fd), dtype, device, generator)
        self.w_up = weight((E, D, Fd), dtype, device, generator)
        self.w_down = weight((E, Fd, D), dtype, device, generator)
        if cfg.moe_shared_ff:
            self.shared = MLP(D, cfg.moe_shared_ff, dtype, device, generator)


def capacity_for(cfg, tokens: int) -> int:
    cap = int(cfg.capacity_factor * tokens * cfg.experts_per_token / cfg.num_experts)
    return max(cap, cfg.experts_per_token, 1)


def route(x, router, k, capacity):
    """Router: returns (weights (T,k) f32, expert ids (T,k) i32, ordinals
    (T,k) i32, keep (T,k) bool, logits (T,E) f32); the weights and logits
    carry the gradient to ``x`` and ``router``."""
    from repro_torch.kernels.moe_route import moe_route

    logits = x.float() @ router
    return (*moe_route(logits, k, capacity), logits)


def _balance_loss(counts, logits, T, K):
    """Switch-style load balancing: E · Σ_e f_e · P_e, ``counts`` (E,) the
    assignments to each expert."""
    f = counts / (T * K)
    P = torch.softmax(logits, dim=-1).mean(dim=0)
    return counts.shape[0] * torch.sum(f * P)


def _with_shared(y, x, p):
    return y + mlp(x, p.shared) if hasattr(p, "shared") else y


def moe_ffn(x, p, cfg, capacity: int | None = None):
    """x: (T, D) flat tokens → (y (T, D), aux_loss scalar)."""
    if cfg.moe_dropless:
        return moe_ffn_dropless(x, p, cfg)
    T, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    C = capacity if capacity is not None else capacity_for(cfg, T)

    w, idx, pos, keep, logits = route(x, p.router, K, C)

    e_flat = idx.reshape(-1).long()  # (T·K,) expert of each assignment
    t_flat = torch.arange(T, device=x.device).repeat_interleave(K)  # its token
    w_flat = w.reshape(-1).to(x.dtype)
    keep = keep.reshape(-1)
    slot = e_flat * C + torch.where(keep, pos.reshape(-1).long(), 0)

    # pack: (E·C, D) buffer; dropped assignments contribute zero
    buf = torch.zeros((E * C, D), dtype=x.dtype, device=x.device)
    buf.index_add_(0, slot, x[t_flat] * keep[:, None].to(x.dtype))
    xe = buf.reshape(E, C, D)

    g = F.silu(torch.einsum("ecd,edf->ecf", xe, p.w_gate))
    u = torch.einsum("ecd,edf->ecf", xe, p.w_up)
    ye = torch.einsum("ecf,efd->ecd", g * u, p.w_down).reshape(E * C, D)

    # unpack: scatter-add weighted expert outputs back to tokens
    contrib = ye[slot] * (w_flat * keep.to(w_flat.dtype))[:, None]
    y = torch.zeros((T, D), dtype=x.dtype, device=x.device).index_add_(0, t_flat, contrib)

    # Switch-style load balancing: E · Σ_e f_e · P_e
    # (bincount's length depends on the data, which a traced program
    # cannot have: count into E fixed bins instead; f32 counts are exact
    # below 2^24 assignments)
    counts = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, e_flat, torch.ones(e_flat.shape, dtype=torch.float32, device=x.device))
    return _with_shared(y, x, p), _balance_loss(counts, logits, T, K)


def moe_ffn_dropless(x, p, cfg):
    """x: (T, D) flat tokens → (y (T, D), aux_loss scalar), every one of the
    T·k assignments computed. Recorded as the program span ``moe.experts``
    (args ``tokens``, ``assignments`` and ``experts_hit``, the experts with
    at least one assignment: a device count, read by ``spans.settle``)."""
    T, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    with span("moe.experts") as sp:
        w, idx, pos, _keep, logits = route(x, p.router, K, max(T * K, 1))
        e_flat = idx.reshape(-1).long()
        counts = torch.zeros(E, dtype=torch.int32, device=x.device).index_add_(
            0, e_flat, torch.ones(e_flat.shape, dtype=torch.int32, device=x.device))
        ends = torch.cumsum(counts, 0, dtype=torch.int32)
        # each assignment's row among those sorted by expert (token-major
        # within an expert, as the router's ordinals count)
        row = ((ends - counts)[e_flat] + pos.reshape(-1)).long()
        t_flat = torch.arange(T * K, device=x.device) // K
        token_of_row = torch.empty_like(t_flat).index_copy_(0, row, t_flat)
        ys = grouped_experts(x[token_of_row], p.w_gate, p.w_up, p.w_down, ends)
        y = (ys[row].view(T, K, D).float() * w[..., None]).sum(1).to(x.dtype)
        if sp:
            sp.args.update(tokens=T, assignments=T * K)
            sp.defer("experts_hit", (counts > 0).sum())
    return _with_shared(y, x, p), _balance_loss(counts.float(), logits, T, K)


def moe_ffn_bsd(x, p, cfg):
    """(B, S, D) wrapper: flattens tokens, restores shape."""
    B, S, D = x.shape
    y, aux = moe_ffn(x.reshape(B * S, D), p, cfg)
    return y.reshape(B, S, D), aux


def moe_apply(x, p, cfg):
    """(B, S, D) MoE with the path chosen by rule: expert parallelism over
    the ambient mesh's data ranks where ``ep_applicable`` holds, the
    flattened-token path otherwise."""
    from repro_torch.models.moe_ep import ep_applicable, moe_ffn_bsd_ep

    if ep_applicable(cfg, x.shape[0]):
        return moe_ffn_bsd_ep(x, p, cfg)
    return moe_ffn_bsd(x, p, cfg)
