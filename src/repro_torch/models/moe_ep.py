"""Expert-parallel MoE dispatch over the ranks of the ambient mesh's data
axis (the port of ``repro.models.moe_ep``).

Per data rank, as the JAX ``shard_map`` region does it:

  route the rank's local tokens (the router kernel, once per rank) →
  bucket each assignment by OWNER rank (expert e lives on rank e // E_loc)
  with per-source capacity → ``alltoall`` (the MPI token exchange,
  ``core/comm``) → the local experts' SwiGLU → ``alltoall`` back (the
  exchange is an involution) → weighted combine at the source; the aux
  loss is the mean over ranks of each rank's local aux (``pmean``).

The ranks are the port's virtual ranks on one device: rank ``r`` holds
batch rows ``[r·B/p, (r+1)·B/p)``, and the send buffer is the rank-major
``(p·p·E_loc·C, D)`` layout ``comm.alltoall`` exchanges.

Capacity is per (source rank, expert): ``C = max(int(cf·T_loc·K/E), K)``
with ``T_loc`` the rank's tokens, not ``capacity_for`` of the whole batch,
so the tokens dropped at a capacity factor below the no-drop level are
the JAX function's, not the flat path's. The router kernel's ordinals are
the send slots: they are token-major and slot-minor per expert within one
call, the stable-argsort rank of the JAX function, so the kernel runs once
per rank (one call over every rank's rows would number ordinals across
ranks), and ``slot = e·C + ordinal`` because ``dest·E_loc + eloc == e``.

The JAX function's ``psum`` over ``"model"`` sums the F-partials of tensor
parallelism; on one card the port computes the whole F product (the sums
agree up to rounding order). Gradients reach ``x``, the router and the
expert weights, the router's through its ``autograd.Function`` as on the
flat path.

``ep_applicable`` is the rule ``moe_apply`` takes EP by: ``cfg.moe_ep``, an
ambient mesh whose data axis has p > 1 ranks, ``E % p == 0`` and
``B % p == 0``; it raises for a config with ``moe_ep`` that is dropless or
has a shared expert (Granite's), which EP does not implement. Where it does not hold the flat path runs, which gives the
JAX package's results for those shapes (its ``moe_apply`` falls back from
the error EP raises there); an error inside EP raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import ambient_mesh
from repro_torch.models.moe import route


def _mesh_axis_size(axis: str):
    mesh = ambient_mesh()
    if mesh is None or axis not in mesh.axis_names:
        return None
    return mesh.shape[axis]


def ep_applicable(cfg, batch: int, axis: str = "data") -> bool:
    """Whether ``moe_apply`` takes EP for a batch of ``batch`` rows. EP has
    a capacity and no shared expert, so it raises for a config with
    ``moe_ep`` that asks for either (``moe_dropless``, ``moe_shared_ff``)
    rather than drop tokens or skip the shared expert."""
    if not getattr(cfg, "moe_ep", False):
        return False
    if getattr(cfg, "moe_dropless", False) or getattr(cfg, "moe_shared_ff", 0):
        raise NotImplementedError(
            f"{cfg.name}: expert parallelism drops past its capacity and has no shared "
            f"expert; moe_dropless {cfg.moe_dropless}, moe_shared_ff {cfg.moe_shared_ff}")
    p = _mesh_axis_size(axis)
    return (p is not None and p > 1 and cfg.num_experts % p == 0
            and batch % p == 0)


def capacity_ep(cfg, tokens_local: int) -> int:
    """Per (source rank, expert) capacity for ``tokens_local`` tokens a rank."""
    K = cfg.experts_per_token
    return max(int(cfg.capacity_factor * tokens_local * K / cfg.num_experts), K)


def moe_ffn_bsd_ep(x, params, cfg, axis: str = "data"):
    """(B, S, D) → (y, aux) over the ambient mesh's ``axis``; raises where
    ``ep_applicable`` does not hold."""
    from repro_torch.core import comm

    mesh = ambient_mesh()
    if not ep_applicable(cfg, x.shape[0], axis):
        raise ValueError(
            f"expert parallelism needs cfg.moe_ep, an ambient mesh with {axis!r} over "
            f"p > 1 ranks, num_experts % p == 0 and batch % p == 0; got moe_ep "
            f"{getattr(cfg, 'moe_ep', False)}, mesh {mesh}, {cfg.num_experts} experts, "
            f"batch {x.shape[0]}")
    ctx = mesh.comm(axis)
    p = ctx.executors
    E, K = cfg.num_experts, cfg.experts_per_token
    E_loc = E // p
    B, S, D = x.shape
    T = B // p * S  # the rank's tokens
    C = capacity_ep(cfg, T)
    dev = x.device
    xr = x.reshape(p, T, D)

    # 1. route each rank's tokens: one router call per rank
    routed = [route(xr[r], params.router, K, C) for r in range(p)]
    w, idx, pos, keep, logits = (torch.stack(t) for t in zip(*routed))

    # 2. bucket by owner rank: slot e·C + ordinal in the rank's send buffer
    #    (E·C rows: p destinations × E_loc experts × C); dropped → row E·C.
    #    One name, ``buf``, carries the rows through steps 2–6, so a step's
    #    input is freed as its output lands (outside autograd).
    e_flat = idx.reshape(p, T * K).long()
    keep = keep.reshape(p, T * K)
    slot = torch.where(keep, e_flat * C + pos.reshape(p, T * K).long(), E * C)
    t_flat = torch.arange(T, device=dev).repeat_interleave(K)
    rows = (torch.arange(p, device=dev)[:, None] * (E * C + 1) + slot).reshape(-1)
    kept = keep[..., None].to(x.dtype)
    buf = torch.zeros((p * (E * C + 1), D), dtype=x.dtype, device=dev).index_add_(
        0, rows, (xr[:, t_flat] * kept).reshape(-1, D))
    buf = buf.reshape(p, E * C + 1, D)[:, :E * C].reshape(p * E * C, D)
    valid = torch.zeros((p * (E * C + 1),), dtype=torch.bool, device=dev)
    valid[rows] = keep.reshape(-1)
    valid = valid.reshape(p, E * C + 1)[:, :E * C].reshape(-1)

    # 3. the token exchange: each rank receives every source's rows for
    #    its E_loc experts
    buf = comm.alltoall(ctx, buf) * comm.alltoall(ctx, valid)[:, None].to(x.dtype)

    # 4. the local experts' SwiGLU, every rank's at once: rank d's expert
    #    l is global expert d·E_loc + l, over p·C rows (source-major)
    buf = buf.reshape(p, p, E_loc, C, D).transpose(1, 2).reshape(E, p * C, D)
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, params.w_gate))
    h = h * torch.einsum("ecd,edf->ecf", buf, params.w_up)
    buf = torch.einsum("ecf,efd->ecd", h, params.w_down)
    del h
    buf = buf.reshape(p, E_loc, p, C, D).transpose(1, 2).reshape(p * E * C, D)

    # 5. exchange back: each source's rows in its send layout
    buf = comm.alltoall(ctx, buf).reshape(p, E * C, D)

    # 6. combine at the source: each kept assignment reads its slot
    buf = torch.cat([buf, buf.new_zeros((p, 1, D))], dim=1).reshape(-1, D)
    scale = (w.reshape(p, T * K).to(x.dtype) * keep.to(x.dtype)).reshape(-1)
    contrib = buf[rows] * scale[:, None]
    del buf
    tok = (torch.arange(p, device=dev)[:, None] * T + t_flat).reshape(-1)
    y = torch.zeros((p * T, D), dtype=x.dtype, device=dev).index_add_(0, tok, contrib)

    # 7. load-balancing aux: local fractions, mean over ranks
    hits = (torch.arange(p, device=dev)[:, None] * E + e_flat).reshape(-1)
    f = torch.bincount(hits, minlength=p * E).reshape(p, E).float() / (T * K)
    Pm = torch.softmax(logits, dim=-1).mean(dim=1)
    aux_local = E * torch.sum(f * Pm, dim=-1)
    aux = comm.allreduce(ctx, aux_local) / p
    return y.reshape(B, S, D), aux
