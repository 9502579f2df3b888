"""Mamba-2 block: SSD (state-space duality) with chunked scan (the port of
``repro.models.mamba2``).

``ssd_chunked`` is the plain version of the SSD scan kernel
(``repro_torch.kernels.ssd_scan``): within a chunk the recurrence is
computed attention-style (decay-masked C·Bᵀ scores); across chunks a Python
loop carries the (H, P, N) state, where the JAX package has a ``lax.scan``.
It rounds to the input dtype at the points the JAX function does.

The one deliberate difference from the JAX package: ``mamba_mixer`` calls
the kernel's wrapper ``ssd_scan`` where the JAX function calls
``ssd_chunked`` directly. On a CPU tensor that wrapper runs ``ssd_chunked``
itself; on a CUDA tensor it launches the kernel. Under grad its backward is
``ssd_chunked``'s own, so the gradients are the JAX function's.

Decode is the O(1) recurrent update: h ← exp(Δ·A)·h + Δ·B⊗x ; y = C·h + D·x.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import dense_init, rmsnorm, weight

# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus


def ssd_chunked(x, dt, A_log, Bm, Cm, chunk, init_state=None):
    """Chunked SSD as a loop over chunks.

    x:  (b, s, h, p)   inputs per head
    dt: (b, s, h)      positive step sizes (softplus already applied)
    A_log: (h,)        A = -exp(A_log)
    Bm, Cm: (b, s, g, n) input/output projections per group (g divides h)
    Returns (y (b, s, h, p) in x's dtype, final_state (b, h, p, n) f32).

    One chunk's (b, q, q, h) decay tensor is live at a time. The tail is
    zero-padded to a whole chunk: dt = 0 there, so decay 1 and input 0 — a
    state no-op.
    """
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    s_real = s
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        s = s + pad
    c, q = s // chunk, chunk
    hpg = h // g
    xt = x.dtype

    a = -torch.exp(A_log.float())[None, None] * dt.float()  # (b, s, h) ≤ 0
    xdt = x * dt[..., None].to(xt)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))

    hs = (init_state.float() if init_state is not None
          else torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device))
    ys = []
    for ci in range(c):
        sl = slice(ci * q, (ci + 1) * q)
        a_c, x_c, B_c, C_c = a[:, sl], xdt[:, sl], Bm[:, sl], Cm[:, sl]
        ca = torch.cumsum(a_c, dim=1)  # (b, q, h)
        # intra-chunk: scores[i, j] = (C_i·B_j)·exp(ca_i − ca_j), j ≤ i; the
        # exponent is masked before exp, so no inf is ever formed
        cb = torch.einsum("bign,bjgn->bgij", C_c.float(), B_c.float())
        seg = ca[:, :, None, :] - ca[:, None, :, :]  # (b, i, j, h)
        decay = torch.exp(torch.where(mask[None, :, :, None], seg, float("-inf")))
        cbh = torch.repeat_interleave(cb, hpg, dim=1)  # (b, h, i, j)
        w_ij = cbh * decay.permute(0, 3, 1, 2)
        y_intra = torch.einsum("bhij,bjhp->bihp", w_ij.to(xt), x_c)
        # inter-chunk from the carried state
        Ch = torch.repeat_interleave(C_c, hpg, dim=2)  # (b, q, h, n)
        y_inter = torch.einsum("bqhn,bhpn->bqhp", Ch.to(xt), hs.to(xt))
        y_inter = y_inter * torch.exp(ca)[..., None].to(xt)
        # state update
        wlast = torch.exp(ca[:, -1:, :] - ca)  # (b, q, h)
        Bh = torch.repeat_interleave(B_c, hpg, dim=2)  # (b, q, h, n)
        st = torch.einsum("bqhp,bqhn->bhpn", wlast.to(xt)[..., None] * x_c, Bh.to(xt))
        hs = torch.exp(ca[:, -1, :])[:, :, None, None] * hs + st.float()
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1) if ys else x.new_zeros((b, 0, h, p))
    return y[:, :s_real], hs


def ssd_decode(state, x, dt, A_log, Bm, Cm):
    """One-step recurrence. state: (b,h,p,n); x: (b,h,p); dt: (b,h);
    Bm, Cm: (b,g,n). Returns (y (b,h,p), new_state)."""
    h = x.shape[1]
    hpg = h // Bm.shape[1]
    a = torch.exp(-torch.exp(A_log.float())[None] * dt.float())  # (b, h)
    Bh = torch.repeat_interleave(Bm, hpg, dim=1)  # (b, h, n)
    Ch = torch.repeat_interleave(Cm, hpg, dim=1)
    upd = (x * dt[..., None])[..., :, None] * Bh[..., None, :]  # (b, h, p, n)
    state = a[..., None, None] * state + upd.to(state.dtype)
    y = torch.einsum("bhpn,bhn->bhp", state, Ch.to(state.dtype))
    return y.to(x.dtype), state


# ---------------------------------------------------------------------------
# Mamba-2 mixer layer
# ---------------------------------------------------------------------------


class Mamba2Mixer(nn.Module):
    """``in_proj`` (D, 2·di + 2·g·n + h) → [z, xBC, dt]; ``conv_w`` (width,
    conv_dim) in the parameter dtype; ``conv_b``, ``dt_bias``, ``A_log``,
    ``Dskip``, ``norm`` in f32 (zeros, zeros, zeros, ones, zeros);
    ``out_proj`` (di, D) — the JAX package's ``make_mamba_params``."""

    def __init__(self, cfg, dtype, device=None, generator=None):
        super().__init__()
        D, di = cfg.d_model, cfg.d_inner
        g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
        conv_dim = di + 2 * g * n
        f32 = dict(dtype=torch.float32, device=device)
        self.in_proj = weight((D, 2 * di + 2 * g * n + h), dtype, device, generator)
        self.conv_w = weight((cfg.ssm_conv, conv_dim), dtype, device, generator,
                             functools.partial(dense_init, in_axis=0))
        self.conv_b = nn.Parameter(torch.zeros(conv_dim, **f32))
        self.dt_bias = nn.Parameter(torch.zeros(h, **f32))
        self.A_log = nn.Parameter(torch.zeros(h, **f32))
        self.Dskip = nn.Parameter(torch.ones(h, **f32))
        self.norm = nn.Parameter(torch.zeros(di, **f32))
        self.out_proj = weight((di, D), dtype, device, generator)


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: (b, s, ch); w: (width, ch)."""
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):  # width is tiny (4): unrolled shifts
        out = out + pad[:, i:i + x.shape[1], :] * w[i][None, None, :]
    return out + b[None, None, :].to(x.dtype)


def mamba_mixer(x, p, cfg):
    """x: (b, s, D) → (y (b, s, D), conv_tail (b, width-1, conv_dim), final_state).

    ``conv_tail`` is the raw (pre-conv) tail of xBC — the decode conv cache.
    """
    from repro_torch.kernels.ssd_scan import ssd_scan

    b, s, _ = x.shape
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    ph = cfg.ssm_headdim

    zxbcdt = x @ p.in_proj
    z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * g * n, h], dim=-1)
    conv_tail = xBC[:, -(cfg.ssm_conv - 1):, :]
    xBC = F.silu(_causal_conv(xBC, p.conv_w, p.conv_b))
    xs, Bm, Cm = torch.split(xBC, [di, g * n, g * n], dim=-1)
    dt = _softplus(dt.float() + p.dt_bias[None, None])

    y, state = ssd_scan(xs.reshape(b, s, h, ph), dt, p.A_log,
                        Bm.reshape(b, s, g, n), Cm.reshape(b, s, g, n), cfg.ssm_chunk)
    y = y + xs.reshape(b, s, h, ph) * p.Dskip[None, None, :, None].to(x.dtype)
    y = y.reshape(b, s, di)
    y = rmsnorm(y * F.silu(z), p.norm, cfg.rms_eps)  # gated RMSNorm (mamba2)
    return y @ p.out_proj, conv_tail, state


def mamba_mixer_decode(x, p, cfg, conv_cache, state):
    """One-token decode. x: (b, 1, D); conv_cache: (b, width-1, conv_dim);
    state: (b, h, p, n). Returns (y (b,1,D), new_conv_cache, new_state) —
    new tensors; the conv cache takes the promoted dtype of the cache and
    the activations, as in the JAX package."""
    b = x.shape[0]
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    ph = cfg.ssm_headdim

    zxbcdt = x[:, 0] @ p.in_proj
    z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * g * n, h], dim=-1)
    wt = torch.promote_types(conv_cache.dtype, xBC.dtype)
    window = torch.cat([conv_cache.to(wt), xBC[:, None, :].to(wt)], dim=1)  # (b, width, ch)
    conv = torch.einsum("bwc,wc->bc", window, p.conv_w.to(wt))
    xBC = F.silu(conv + p.conv_b[None].to(wt))
    xs, Bm, Cm = torch.split(xBC, [di, g * n, g * n], dim=-1)
    dt = _softplus(dt.float() + p.dt_bias[None])

    y, state = ssd_decode(state, xs.reshape(b, h, ph), dt, p.A_log,
                          Bm.reshape(b, g, n), Cm.reshape(b, g, n))
    y = y + xs.reshape(b, h, ph) * p.Dskip[None, :, None].to(x.dtype)
    y = y.reshape(b, di)
    y = rmsnorm(y * F.silu(z), p.norm, cfg.rms_eps)
    return (y @ p.out_proj)[:, None, :], window[:, 1:], state
