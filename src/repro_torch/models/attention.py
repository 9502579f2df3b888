"""GQA attention: query-chunked (memory O(S·chunk)), window/causal masks,
qk-norm, logit soft-cap, prefill + decode paths (the port of
``repro.models.attention``).

The chunked path here is the plain one; ``cfg.attn_impl == "flash"``
dispatches prefill and the training forward to the flash kernel
(``repro_torch.kernels.flash_attention``: CUDA on the card, its plain
version on the CPU; differentiable through its ``autograd.Function``,
whose backward on the card in bf16 at hd 64 and 128 is the backward kernel
``flash_attention_bwd``, and elsewhere the plain version's vjp, as in the
JAX package), and decode
to the decode kernel (``repro_torch.kernels.decode_attention``).
``attention(..., kv=)`` is cross-attention (the encoder-decoder's decoder):
k and v are projected from ``kv``, without RoPE, and flash runs with the
queries' offset 0 into the keys. A config's ``attn_scale`` is folded into
the queries (``_scaled``), so the kernels keep their ``head_dim^-1/2``.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import rmsnorm, rope, softcap, weight
from repro_torch.profile import cost

NEG_INF = -1e30
GLOBAL_WINDOW = 1 << 30  # "no window" sentinel


class Attention(nn.Module):
    """``wq`` (D, H·hd), ``wk``/``wv`` (D, K·hd), ``wo`` (H·hd, D) in the
    parameter dtype; ``q_norm``/``k_norm`` (hd,) in f32 with qk-norm."""

    def __init__(self, cfg, dtype, device=None, generator=None):
        super().__init__()
        self.wq = weight((cfg.d_model, cfg.q_dim), dtype, device, generator)
        self.wk = weight((cfg.d_model, cfg.kv_dim), dtype, device, generator)
        self.wv = weight((cfg.d_model, cfg.kv_dim), dtype, device, generator)
        self.wo = weight((cfg.q_dim, cfg.d_model), dtype, device, generator)
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.zeros(cfg.head_dim, device=device))
            self.k_norm = nn.Parameter(torch.zeros(cfg.head_dim, device=device))


def _mask_bias(pos_q, pos_kv, window, causal):
    """(…, Sq, Skv) additive f32 bias from position vectors; GLOBAL_WINDOW
    means unbounded."""
    dq = pos_q[..., :, None]
    dk = pos_kv[..., None, :]
    ok = dk >= 0  # negative kv positions = padding (unwritten cache slots)
    if causal:
        ok = ok & (dk <= dq)
    ok = ok & ((dq - dk) < window)
    return torch.where(ok, 0.0, NEG_INF)


def _attend_block(q, k, v, bias, scale, cap):
    """q: (B,Sq,K,G,hd) k/v: (B,Skv,K,hd) bias: (B,Sq,Skv) → (B,Sq,K,G,hd).
    Scores in f32 from the inputs' exact values, as the JAX package's
    ``preferred_element_type=f32``; probabilities cast to v's dtype."""
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float())
    s = softcap(s * scale, cap) + bias[:, None, None, :, :]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)


def attend(q, k, v, pos_q, pos_kv, *, window=GLOBAL_WINDOW, causal=True, cap=0.0,
           chunk=0):
    """Grouped-query attention with on-the-fly masks.

    q: (B, Sq, H, hd); k, v: (B, Skv, K, hd); H = K·G.
    pos_q: (B, Sq) int32; pos_kv: (B, Skv) int32 (negative = invalid slot).
    ``chunk`` > 0 processes queries in blocks of ``chunk`` rows (a loop), so
    the full (Sq, Skv) score matrix is never held, in the forward nor,
    under grad, between the forward and the backward.
    """
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    scale = hd**-0.5
    qg = q.reshape(B, Sq, K, G, hd)
    step = chunk if chunk and Sq > chunk else Sq
    # under grad, each whole chunk is recomputed in the backward instead of
    # keeping its probabilities (the JAX function's ``@jax.checkpoint`` on
    # the ``lax.map`` body); a single block and the remainder are not
    remat = step < Sq and torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)

    def block(qb, pb):
        return _attend_block(qb, k, v, _mask_bias(pb, pos_kv, window, causal), scale, cap)

    def chunk(i):
        qb, pb = qg[:, i:i + step], pos_q[:, i:i + step]
        if remat and i + step <= Sq:
            return checkpoint(block, qb, pb, use_reentrant=False)
        return block(qb, pb)

    n_full = Sq // step
    if n_full > 1 and not remat and cost.collapses():
        # a trace for pricing: the whole chunks are identical, so one is
        # traced and priced n_full times (profile.cost.repeated)
        with cost.repeated(n_full):
            outs = [chunk(0)] * n_full
        if Sq % step:
            outs.append(chunk(n_full * step))
    else:
        outs = [chunk(i) for i in range(0, Sq, step)]
    o = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return o.reshape(B, Sq, H, hd)


def _scaled(q, cfg):
    """``q`` times ``attn_scale / head_dim^-1/2`` where the config states a
    softmax scale (``attn_scale``, granite's ``attention_multiplier``), so
    that every attention path, which scales scores by ``head_dim^-1/2``,
    scales them by ``attn_scale``; ``q`` itself otherwise. The product is
    taken in f32 and rounded once to ``q``'s dtype."""
    if not cfg.attn_scale:
        return q
    return (q.float() * (cfg.attn_scale * cfg.head_dim ** 0.5)).to(q.dtype)


def _promote(o, w):
    """``o @ w`` with the JAX package's type promotion (a bf16 attention
    output meets an f32 projection in an f32 model's decode)."""
    dt = torch.promote_types(o.dtype, w.dtype)
    return o.to(dt) @ w.to(dt)


def attention(x, p, cfg, pos, *, kv=None, window=GLOBAL_WINDOW, causal=True, pos_kv=None,
              static_window=True):
    """Full attention sub-layer for prefill and training.

    x: (B, S, D). If ``kv`` (B, Skv, D) is given, computes cross-attention
    (k/v projected from ``kv``; no RoPE on cross-attention; qk-norm still
    applies). Returns (out, (k_heads, v_heads)) — the per-head K/V for
    cache writes.

    cfg.attn_impl == "flash" dispatches to the flash kernel when the mask is
    expressible: no per-position invalidation (``pos_kv is None``) and a
    window that is the same for every layer (``static_window``; the JAX
    package's rule is that the window is not traced, which it is exactly
    when the layers' windows differ).
    """
    B, S, _ = x.shape
    q = (x @ p.wq).reshape(B, S, cfg.num_heads, cfg.head_dim)
    src = kv if kv is not None else x
    Skv = src.shape[1]
    k = (src @ p.wk).reshape(B, Skv, cfg.num_kv_heads, cfg.head_dim)
    v = (src @ p.wv).reshape(B, Skv, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm)
        k = rmsnorm(k, p.k_norm)
    if kv is None and cfg.rope_theta:
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    q = _scaled(q, cfg)
    if cfg.attn_impl == "flash" and pos_kv is None and static_window:
        from repro_torch.kernels.flash_attention import flash_attention

        win = None if (window is None or window >= GLOBAL_WINDOW) else int(window)
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            causal, win, cfg.attn_logit_softcap,
                            (Skv - S) if kv is None else 0).transpose(1, 2)
        return o.reshape(B, S, cfg.q_dim) @ p.wo, (k, v)
    if pos_kv is None:
        pos_kv = pos if kv is None else torch.arange(
            Skv, dtype=torch.int32, device=x.device)[None].expand(B, Skv)
    o = attend(q, k, v, pos, pos_kv, window=window, causal=causal,
               cap=cfg.attn_logit_softcap, chunk=cfg.attn_chunk)
    return o.reshape(B, S, cfg.q_dim) @ p.wo, (k, v)


def decode_attention(x, p, cfg, pos, k_cache, v_cache, *, window=GLOBAL_WINDOW):
    """One-token decode against a KV cache.

    x: (B, 1, D); pos: (B,) current positions; caches: (B, Smax, K, hd).
    Writes the new K/V into the caches IN PLACE at ``pos`` (clamped to the
    last slot, as ``dynamic_update_slice`` clamps) and returns (out,
    k_cache, v_cache) — the same cache tensors. Cache slots at index > pos
    are masked. ``cfg.attn_impl == "flash"`` dispatches, as prefill does,
    to the decode kernel (``repro_torch.kernels.decode_attention``: on the
    card it reads each slot's live rows of the bf16 slab in place, up to
    ``pos``; on the CPU its plain version); otherwise the plain version
    runs: the masked ``attend`` over the whole cache, as in the JAX package.
    """
    B = x.shape[0]
    q = (x @ p.wq).reshape(B, 1, cfg.num_heads, cfg.head_dim)
    k_new = (x @ p.wk).reshape(B, 1, cfg.num_kv_heads, cfg.head_dim)
    v_new = (x @ p.wv).reshape(B, 1, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm)
        k_new = rmsnorm(k_new, p.k_norm)
    if cfg.rope_theta:
        q = rope(q, pos[:, None], cfg.rope_theta)
        k_new = rope(k_new, pos[:, None], cfg.rope_theta)
    q = _scaled(q, cfg)

    Smax = k_cache.shape[1]
    rows = torch.arange(B, device=x.device)
    at = pos.long().clamp(0, Smax - 1)
    k_cache[rows, at] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, at] = v_new[:, 0].to(v_cache.dtype)

    from repro_torch.kernels import decode_attention as kernels

    attend_cache = (kernels.decode_attention if cfg.attn_impl == "flash"
                    else kernels.decode_attention_ref)
    o = attend_cache(q, k_cache, v_cache, pos, window=window, softcap=cfg.attn_logit_softcap)
    return _promote(o.reshape(B, 1, cfg.q_dim), p.wo), k_cache, v_cache
