"""Shared building blocks: norms, RoPE, the SwiGLU MLP, initialisers and
the sequence-chunked cross-entropy of the training path (the port of
``repro.models.layers``).

Parameters live in ``nn.Module``s (the JAX package's ``make_*_params``
functions become their constructors) whose tensors keep the JAX package's
layouts (a dense weight is ``(in, out)`` and applied as ``x @ w``).
Initialisers take an explicit ``torch.Generator``; its device is where the
tensor is made. Norms and RoPE compute in f32 and cast back to the input's
dtype, as the JAX package does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(shape, generator, dtype=torch.float32, in_axis=-2):
    """Truncated-normal fan-in init (as used by llama-family codebases),
    drawn in f32 one tensor at a time and cast to ``dtype``."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(1.0 / math.sqrt(fan_in)).to(dtype)


def embed_init(shape, generator, dtype=torch.float32):
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return w.normal_(0.0, 0.02, generator=generator).to(dtype)


def weight(shape, dtype, device=None, generator=None, init=dense_init) -> nn.Parameter:
    """A weight drawn by ``init`` from ``generator`` (on the generator's
    device, which the caller passes as ``device`` too), or left
    uninitialised on ``device`` when there is no generator (to be filled
    from elsewhere, as ``interop.params_from_reference`` does)."""
    if generator is None:
        return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
    return nn.Parameter(init(shape, generator, dtype))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm(x, scale=None, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    if scale is not None:
        x = x * (1.0 + scale.float())
    return x.to(dt)


def layernorm(x, scale=None, bias=None, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        x = x * scale.float()
    if bias is not None:
        x = x + bias.float()
    return x.to(dt)


class Norm(nn.Module):
    """Norm parameters (f32): ``scale`` for rmsnorm (the ``1 + scale``
    convention, zeros), ``scale``/``bias`` for layernorm, none for olmo's
    non-parametric LayerNorm."""

    def __init__(self, d: int, norm_type: str, device=None):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        if norm_type == "rmsnorm":
            self.scale = nn.Parameter(torch.zeros(d, **f32))
        elif norm_type == "layernorm":
            self.scale = nn.Parameter(torch.ones(d, **f32))
            self.bias = nn.Parameter(torch.zeros(d, **f32))
        elif norm_type != "nonparam_ln":
            raise ValueError(norm_type)


def apply_norm(x, p, norm_type, eps=1e-6):
    """``x`` through the norm ``p`` of ``norm_type``; ``eps`` is the
    rmsnorm's (a config's ``rms_eps``)."""
    if norm_type == "rmsnorm":
        return rmsnorm(x, p.scale, eps)
    if norm_type == "layernorm":
        return layernorm(x, p.scale, p.bias)
    if norm_type == "nonparam_ln":
        return layernorm(x)
    raise ValueError(norm_type)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x, positions, theta):
    """Apply rotary embedding. x: (..., S, H, hd); positions: (..., S)."""
    if not theta:
        return x
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32, device=x.device)
                      * (math.log(theta) / half))
    ang = positions.float()[..., None] * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """SwiGLU weights: ``w_gate``/``w_up`` (d, f), ``w_down`` (f, d)."""

    def __init__(self, d: int, f: int, dtype, device=None, generator=None):
        super().__init__()
        self.w_gate = weight((d, f), dtype, device, generator)
        self.w_up = weight((d, f), dtype, device, generator)
        self.w_down = weight((f, d), dtype, device, generator)


def mlp(x, p):
    g = F.silu(x @ p.w_gate)
    u = x @ p.w_up
    return (g * u) @ p.w_down


# ---------------------------------------------------------------------------
# LM head / loss
# ---------------------------------------------------------------------------


def lm_logits(h, head):
    """h: (B, S, D); head: (D, V) (already transposed if tied)."""
    return h @ head


def _ce_block(logits, labels):
    """f32 cross-entropy; labels < 0 are masked out. Returns (sum, count)."""
    logits = logits.float()
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    ce = (lse - gold) * mask
    return ce.sum(), mask.sum()


def lm_loss(h, head, labels, chunk=0):
    """Cross-entropy over the vocabulary.

    ``chunk`` > 0 computes logits in sequence chunks of ``chunk`` positions
    (a loop, where the JAX function has ``lax.map``), so the forward never
    holds the whole (B, S, V) tensor at once (needed for 262k
    vocabularies); the remainder past the last whole chunk is one more
    block, as in the JAX function."""
    if not chunk or h.shape[1] <= chunk:
        s, c = _ce_block(lm_logits(h, head), labels)
        return s / torch.clamp_min(c, 1)
    S = h.shape[1]
    n = S // chunk
    sums, counts = [], []
    for i in range(n):
        s, c = _ce_block(lm_logits(h[:, i * chunk:(i + 1) * chunk], head),
                         labels[:, i * chunk:(i + 1) * chunk])
        sums.append(s)
        counts.append(c)
    total, count = torch.stack(sums).sum(), torch.stack(counts).sum()
    if n * chunk < S:
        s, c = _ce_block(lm_logits(h[:, n * chunk:], head), labels[:, n * chunk:])
        total, count = total + s, count + c
    return total / torch.clamp_min(count, 1)


def softcap(x, cap):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap
