"""Plain torch version of the flash attention kernel (the counterpart of
the JAX package's jnp oracle).

Layout: q (B, H, Sq, hd); k, v (B, K, Skv, hd) with H = K·G (GQA).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window=None, softcap=0.0, q_offset=0):
    B, H, Sq, hd = q.shape
    K = k.shape[1]
    G = H // K
    Skv = k.shape[2]
    kk = k.repeat_interleave(G, dim=1)
    vv = v.repeat_interleave(G, dim=1)
    # scores in f32 from the inputs' exact values (preferred_element_type)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float())
    s = s * (hd**-0.5)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    iq = torch.arange(Sq, device=q.device)[:, None] + q_offset
    ik = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= ik <= iq
    if window is not None:
        ok &= (iq - ik) < window
    s = torch.where(ok[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), vv)
