"""The Mamba-2 language model (arXiv:2405.21060), written out plainly in
float32, with the SSD scan in the paper's minimal "segsum" form.

Per layer: ``x += Mixer(RMSNorm(x))``. The mixer projects ``x`` to ``z``,
``xBC`` and ``dt``; ``xBC`` goes through a causal depthwise convolution of
width ``conv`` (with bias) and SiLU and splits into ``x``, ``B``, ``C``;
``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the SSD scan gives
``y_t = sum_{s<=t} C_t . B_s exp(sum_{s<k<=t} dt_k A) dt_s x_s``, then
``y += D x``, the gated RMSNorm ``RMSNorm(y * silu(z))`` and the output
projection. RMSNorm scales by ``1 + scale`` with eps 1e-6. A final RMSNorm,
then logits against the embedding matrix (tied).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from chipbench.reference.dense import cross_entropy, head
from chipbench.reference.precision import einsum, mm

MIXER_KEYS = ("in_proj", "conv_w", "conv_b", "dt_bias", "A_log", "Dskip", "norm", "out_proj")


def dims(sz: dict) -> dict:
    di = sz["ssm_expand"] * sz["d_model"]
    g, n = sz["ssm_groups"], sz["ssm_state"]
    return dict(di=di, g=g, n=n, h=di // sz["ssm_headdim"], p=sz["ssm_headdim"],
                conv_dim=di + 2 * g * n)


def param_specs(sz: dict) -> list:
    """``[(name, shape, dtype, init)]``: the embedding N(0, 0.02²), each
    matrix N(0, 1/fan_in), the conv kernel N(0, 1/width); ``A_log`` the log
    of U(1, 16) and ``dt_bias`` the inverse softplus of a step log-uniform
    in [dt_min, dt_max], as Mamba-2 initialises them; norm scales zero
    (``1 + scale``), ``D`` one, the conv bias zero."""
    D, V, dt = sz["d_model"], sz["vocab_size"], sz["param_dtype"]
    d = dims(sz)
    f32 = "float32"
    out = [("embed", (V, D), dt, ("normal", 0.02))]
    for i in range(sz["num_layers"]):
        m = f"layers.{i}.mixer."
        out += [
            (f"layers.{i}.ln.scale", (D,), f32, ("const", 0.0)),
            (m + "in_proj", (D, 2 * d["di"] + 2 * d["g"] * d["n"] + d["h"]), dt,
             ("normal", 1 / math.sqrt(D))),
            (m + "conv_w", (sz["ssm_conv"], d["conv_dim"]), dt,
             ("normal", 1 / math.sqrt(sz["ssm_conv"]))),
            (m + "conv_b", (d["conv_dim"],), f32, ("const", 0.0)),
            (m + "dt_bias", (d["h"],), f32, ("dt_bias", sz["dt_min"], sz["dt_max"])),
            (m + "A_log", (d["h"],), f32, ("a_log", 1.0, 16.0)),
            (m + "Dskip", (d["h"],), f32, ("const", 1.0)),
            (m + "norm", (d["di"],), f32, ("const", 0.0)),
            (m + "out_proj", (d["di"], D), dt, ("normal", 1 / math.sqrt(d["di"]))),
        ]
    out.append(("final_norm.scale", (D,), f32, ("const", 0.0)))
    return out


def rmsnorm(x, scale, eps=1e-6):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + scale)


def segsum(a):
    """(..., T) -> (..., T, T): ``out[i, j] = sum_{j<k<=i} a_k`` for j <= i,
    -inf above the diagonal (the stable form: a masked cumulative sum)."""
    T = a.shape[-1]
    x = a[..., None].expand(*a.shape, T)
    below = torch.ones(T, T, dtype=torch.bool, device=a.device).tril(-1)
    x = torch.cumsum(x.masked_fill(~below, 0.0), dim=-2)
    return x.masked_fill(~torch.ones(T, T, dtype=torch.bool, device=a.device).tril(),
                         float("-inf"))


def ssd(x, dt, A, Bm, Cm, chunk, mode="f32"):
    """x (b, s, h, p), dt (b, s, h), A (h,) negative, Bm/Cm (b, s, g, n) ->
    y (b, s, h, p); the sequence is cut into chunks of ``chunk``, zero-padded
    at the tail (a step of 0 neither decays nor adds)."""
    b, s, h, p = x.shape
    g = Bm.shape[2]
    pad = (-s) % chunk
    if pad:
        x, Bm, Cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, Bm, Cm))
        dt = F.pad(dt, (0, 0, 0, pad))
    c, L = (s + pad) // chunk, chunk
    X = (x * dt[..., None]).reshape(b, c, L, h, p)
    a = (dt * A).reshape(b, c, L, h).permute(0, 3, 1, 2)  # (b, h, c, l)
    Bh = Bm.reshape(b, c, L, g, -1).repeat_interleave(h // g, dim=3)  # (b, c, l, h, n)
    Ch = Cm.reshape(b, c, L, g, -1).repeat_interleave(h // g, dim=3)
    acs = torch.cumsum(a, dim=-1)
    # within each chunk: decay-masked C.B scores against the inputs
    decay = torch.exp(segsum(a)).permute(0, 2, 1, 3, 4)  # (b, c, h, l, s)
    scores = einsum("bclhn,bcshn->bchls", Ch, Bh, mode) * decay
    y = einsum("bchls,bcshp->bclhp", scores, X, mode)
    # each chunk's state, then the states carried across chunks
    tail = torch.exp(acs[..., -1:] - acs).permute(0, 2, 3, 1)  # (b, c, l, h)
    states = einsum("bclhn,bclhp->bchpn", Bh * tail[..., None], X, mode)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    carry = torch.exp(segsum(F.pad(acs[..., -1], (1, 0))))  # (b, h, c+1, c+1)
    states = torch.einsum("bhzc,bchpn->bzhpn", carry, states)[:, :-1]
    into = torch.exp(acs).permute(0, 2, 3, 1)  # (b, c, l, h)
    y = y + einsum("bclhn,bchpn->bclhp", Ch, states, mode) * into[..., None]
    return y.reshape(b, c * L, h, p)[:, :s]


def _layer(x, ln, in_proj, conv_w, conv_b, dt_bias, A_log, Dskip, norm, out_proj, sz, mode):
    B, S, D = x.shape
    d = dims(sz)
    u = rmsnorm(x, ln).reshape(B * S, D)
    zxbcdt = mm(u, in_proj, mode).reshape(B, S, -1)
    z, xBC, dt = torch.split(zxbcdt, [d["di"], d["conv_dim"], d["h"]], dim=-1)
    width = conv_w.shape[0]
    conv = F.conv1d(F.pad(xBC.transpose(1, 2), (width - 1, 0)),
                    conv_w.T[:, None, :], conv_b, groups=d["conv_dim"])
    xBC = F.silu(conv.transpose(1, 2))
    xs, Bm, Cm = torch.split(xBC, [d["di"], d["g"] * d["n"], d["g"] * d["n"]], dim=-1)
    dt = F.softplus(dt + dt_bias)
    xs = xs.reshape(B, S, d["h"], d["p"])
    y = ssd(xs, dt, -torch.exp(A_log), Bm.reshape(B, S, d["g"], d["n"]),
            Cm.reshape(B, S, d["g"], d["n"]), sz["ssm_chunk"], mode)
    y = (y + xs * Dskip[:, None]).reshape(B, S, d["di"])
    y = rmsnorm(y * F.silu(z), norm).reshape(B * S, d["di"])
    return x + mm(y, out_proj, mode).reshape(B, S, D)


def hidden(params: dict, tokens: torch.Tensor, sz: dict, mode="f32", remat=True):
    x = params["embed"][tokens.long()]
    for i in range(sz["num_layers"]):
        w = [params[f"layers.{i}.ln.scale"]] + [params[f"layers.{i}.mixer.{k}"]
                                                 for k in MIXER_KEYS]
        if remat and torch.is_grad_enabled():
            x = checkpoint(_layer, x, *w, sz, mode, use_reentrant=False)
        else:
            x = _layer(x, *w, sz, mode)
    return rmsnorm(x, params["final_norm.scale"])


def train_loss(params, batch, sz, mode="f32"):
    h = hidden(params, batch["tokens"], sz, mode)
    return cross_entropy(h, head(params), batch["labels"], mode)


@torch.no_grad()
def logits(params, tokens, sz, mode="f32", start=0):
    h = hidden(params, tokens, sz, mode, remat=False)[0, start:]
    return mm(h, head(params), mode)
