"""Decoder-only transformer with non-parametric LayerNorm and a tied head
(OLMo, arXiv:2402.00838), written out plainly in float32.

Per layer: ``x += Attn(LN(x))``, ``x += MLP(LN(x))``; LN subtracts the
mean and divides by the root of the variance plus 1e-5, with no scale or
bias; attention is causal multi-head attention with rotary embeddings on
the query and key (the halves rotated: the first half of each head against
the second, frequencies ``theta^(-i/half)``), scaled by head_dim^-1/2; the
MLP is SwiGLU, ``(silu(x Wg) * (x Wu)) Wd``. A final LN, then logits
against the embedding matrix (tied). Weights are laid out ``(in, out)``
and named as the harness hands them over.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from chipbench.reference.precision import einsum, mm

LAYER_KEYS = ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "ffn.w_gate", "ffn.w_up",
              "ffn.w_down")


def param_specs(sz: dict) -> list:
    """``[(name, shape, dtype, init)]`` of the model's weights: the embedding
    drawn N(0, 0.02²), each matrix N(0, 1/fan_in)."""
    D, F, V = sz["d_model"], sz["d_ff"], sz["vocab_size"]
    q, kv = sz["num_heads"] * sz["head_dim"], sz["num_kv_heads"] * sz["head_dim"]
    dt = sz["param_dtype"]
    shapes = {"attn.wq": (D, q), "attn.wk": (D, kv), "attn.wv": (D, kv), "attn.wo": (q, D),
              "ffn.w_gate": (D, F), "ffn.w_up": (D, F), "ffn.w_down": (F, D)}
    out = [("embed", (V, D), dt, ("normal", 0.02))]
    for i in range(sz["num_layers"]):
        for k in LAYER_KEYS:
            s = shapes[k]
            out.append((f"layers.{i}.{k}", s, dt, ("normal", 1.0 / math.sqrt(s[0]))))
    return out


def layernorm(x, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps)


def rotary(x, theta):
    """x: (B, S, H, hd) at positions 0 .. S-1."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv[None, :]
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _layer(x, wq, wk, wv, wo, wg, wu, wd, sz, mode):
    B, S, D = x.shape
    H, K, hd = sz["num_heads"], sz["num_kv_heads"], sz["head_dim"]
    h = layernorm(x).reshape(B * S, D)
    q = mm(h, wq, mode).reshape(B, S, H, hd)
    k = mm(h, wk, mode).reshape(B, S, K, hd)
    v = mm(h, wv, mode).reshape(B, S, K, hd)
    q, k = rotary(q, sz["rope_theta"]), rotary(k, sz["rope_theta"])
    if K != H:
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
    s = einsum("bqhd,bkhd->bhqk", q, k, mode) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    del s
    o = einsum("bhqk,bkhd->bqhd", p, v, mode).reshape(B * S, H * hd)
    x = x + mm(o, wo, mode).reshape(B, S, D)
    h = layernorm(x).reshape(B * S, D)
    g = mm(h, wg, mode)
    m = mm(torch.nn.functional.silu(g) * mm(h, wu, mode), wd, mode)
    return x + m.reshape(B, S, D)


def hidden(params: dict, tokens: torch.Tensor, sz: dict, mode="f32", remat=True):
    """tokens (B, S) -> the final LN's output (B, S, D), float32; with
    ``remat`` each layer is recomputed in the backward (memory only)."""
    x = params["embed"][tokens.long()]
    for i in range(sz["num_layers"]):
        w = [params[f"layers.{i}.{k}"] for k in LAYER_KEYS]
        if remat and torch.is_grad_enabled():
            x = checkpoint(_layer, x, *w, sz, mode, use_reentrant=False)
        else:
            x = _layer(x, *w, sz, mode)
    return layernorm(x)


def head(params):
    return params["embed"].T


def cross_entropy(h, head_w, labels, mode, rows=8192):
    """Mean next-token cross-entropy over the labels that are >= 0, the
    logits taken in blocks of ``rows`` positions, each block recomputed in
    the backward."""
    D = h.shape[-1]
    hf, lf = h.reshape(-1, D), labels.reshape(-1)

    def block(hb, lb):
        logits = mm(hb, head_w, mode)
        ok = lb >= 0
        gold = logits.gather(1, torch.where(ok, lb, 0).long()[:, None])[:, 0]
        return ((torch.logsumexp(logits, -1) - gold) * ok).sum()

    total = 0.0
    for i in range(0, hf.shape[0], rows):
        hb, lb = hf[i:i + rows], lf[i:i + rows]
        total = total + (checkpoint(block, hb, lb, use_reentrant=False)
                         if torch.is_grad_enabled() else block(hb, lb))
    return total / (lf >= 0).sum().clamp_min(1)


def train_loss(params, batch, sz, mode="f32"):
    h = hidden(params, batch["tokens"], sz, mode)
    return cross_entropy(h, head(params), batch["labels"], mode)


@torch.no_grad()
def logits(params, tokens, sz, mode="f32", start=0):
    """tokens (1, L) -> float32 logits (L - start, V) at positions start ..
    L-1: the full forward pass, no cache."""
    h = hidden(params, tokens, sz, mode, remat=False)[0, start:]
    return mm(h, head(params), mode)
