"""The hybrid Mamba-2 + attention language model with a routed MoE and a
shared expert in every layer (IBM Granite 4.0-H, Hugging Face's
``granitemoehybrid``), written out plainly in float32.

The layers follow ``layer_pattern`` ("M" Mamba-2, "A" attention), one
period after another, for ``num_layers`` layers. The embedding is
multiplied by ``embed_multiplier``. Each layer:

    x += residual_multiplier * Mixer(RMSNorm(x))
    x += residual_multiplier * (MoE(RMSNorm(x)) + Shared(RMSNorm(x)))

The Mamba-2 mixer is ``reference/ssm.py``'s (its SSD scan in the paper's
"segsum" form), with the gated RMSNorm at ``rms_eps``. Attention is causal
grouped-query attention with no positional encoding, its scores scaled by
``attn_scale``. The MoE: router logits ``x @ router``, the top
``experts_per_token`` of them, a softmax over those, and each routed
(token, expert) pair computed, ``(silu(x Wg) * (x Wu)) Wd``, weighted and
summed, with no capacity and nothing dropped; the shared expert is one more
SwiGLU every token takes. A final RMSNorm, then logits against the
embedding (tied), divided by ``logits_scaling``.

Departures from the Hugging Face code, none of which changes the function
of the weights the harness draws:

- RMSNorm is written ``x / rms(x) * (1 + scale)``, the scales drawn zero
  (Hugging Face: ``weight * x / rms(x)``, the weights one).
- The experts' gate and up projections are two matrices, ``(in, out)``,
  where Hugging Face keeps one ``input_linear`` of both, ``(out, in)``;
  the shared expert likewise.
- The router's softmax over the chosen logits is taken in f32 and its
  weights kept in f32 (Hugging Face casts them to the activations' dtype).
- Every product is in float32 with TF32 off (``precision``), where Hugging
  Face runs in the checkpoint's bfloat16.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from chipbench.reference.dense import cross_entropy
from chipbench.reference.precision import einsum, mm
from chipbench.reference.ssm import MIXER_KEYS, dims, rmsnorm, ssd


def layout(sz: dict) -> list:
    """``[(slot name, mixer)]`` of the layers: ``("blocks.<b>.s<i>",
    "mamba")`` or ``("blocks.<b>.attn", "attn")``, period after period."""
    pat = sz["layer_pattern"]
    out = []
    for layer in range(sz["num_layers"]):
        b, i = divmod(layer, len(pat))
        out.append((f"blocks.{b}.attn", "attn") if pat[i] == "A"
                   else (f"blocks.{b}.s{i}", "mamba"))
    return out


def param_specs(sz: dict) -> list:
    """``[(name, shape, dtype, init)]`` of the model's weights: the embedding
    N(0, (0.02 / embed_multiplier)²), so that its rows enter the residual
    stream at the 0.02 of the other configurations' embeddings (drawn at
    0.02 and multiplied by 12, a random model's stream is its input row, the
    tied head puts that token first by a margin no rounding moves, and the
    check could not tell bf16 from the fp8 control); each matrix
    N(0, 1/fan_in) (the router in float32), the conv kernel N(0, 1/width);
    ``A_log`` the log of U(1, 16) and ``dt_bias`` the inverse softplus of a
    step log-uniform in [dt_min, dt_max], as Mamba-2 initialises them; norm
    scales zero (``1 + scale``), ``D`` one, the conv bias zero."""
    D, V, dt = sz["d_model"], sz["vocab_size"], sz["param_dtype"]
    E, Fe, Fs = sz["num_experts"], sz["d_ff"], sz["moe_shared_ff"]
    q, kv = sz["num_heads"] * sz["head_dim"], sz["num_kv_heads"] * sz["head_dim"]
    d = dims(sz)
    f32 = "float32"

    def normal(fan_in):
        return ("normal", 1.0 / math.sqrt(fan_in))

    out = [("embed", (V, D), dt, ("normal", 0.02 / sz["embed_multiplier"]))]
    for name, mixer in layout(sz):
        out.append((f"{name}.ln1.scale", (D,), f32, ("const", 0.0)))
        if mixer == "attn":
            a = f"{name}.attn."
            out += [(a + "wq", (D, q), dt, normal(D)), (a + "wk", (D, kv), dt, normal(D)),
                    (a + "wv", (D, kv), dt, normal(D)), (a + "wo", (q, D), dt, normal(q))]
        else:
            m = f"{name}.mixer."
            out += [
                (m + "in_proj", (D, 2 * d["di"] + 2 * d["g"] * d["n"] + d["h"]), dt,
                 normal(D)),
                (m + "conv_w", (sz["ssm_conv"], d["conv_dim"]), dt, normal(sz["ssm_conv"])),
                (m + "conv_b", (d["conv_dim"],), f32, ("const", 0.0)),
                (m + "dt_bias", (d["h"],), f32, ("dt_bias", sz["dt_min"], sz["dt_max"])),
                (m + "A_log", (d["h"],), f32, ("a_log", 1.0, 16.0)),
                (m + "Dskip", (d["h"],), f32, ("const", 1.0)),
                (m + "norm", (d["di"],), f32, ("const", 0.0)),
                (m + "out_proj", (d["di"], D), dt, normal(d["di"])),
            ]
        f = f"{name}.ffn."
        out += [(f"{name}.ln2.scale", (D,), f32, ("const", 0.0)),
                (f + "router", (D, E), f32, normal(D)),
                (f + "w_gate", (E, D, Fe), dt, normal(D)),
                (f + "w_up", (E, D, Fe), dt, normal(D)),
                (f + "w_down", (E, Fe, D), dt, normal(Fe)),
                (f + "shared.w_gate", (D, Fs), dt, normal(D)),
                (f + "shared.w_up", (D, Fs), dt, normal(D)),
                (f + "shared.w_down", (Fs, D), dt, normal(Fs))]
    out.append(("final_norm.scale", (D,), f32, ("const", 0.0)))
    return out


def mixer(u, in_proj, conv_w, conv_b, dt_bias, A_log, Dskip, norm, out_proj, sz, mode):
    """The Mamba-2 mixer of ``u`` (B, S, D), normed already."""
    B, S, D = u.shape
    d = dims(sz)
    zxbcdt = mm(u.reshape(B * S, D), in_proj, mode).reshape(B, S, -1)
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
    y = rmsnorm(y * F.silu(z), norm, sz["rms_eps"]).reshape(B * S, d["di"])
    return mm(y, out_proj, mode).reshape(B, S, D)


def attention(u, wq, wk, wv, wo, sz, mode):
    """Causal GQA of ``u`` (B, S, D), normed already; no positional
    encoding; scores scaled by ``attn_scale``."""
    B, S, D = u.shape
    H, K, hd = sz["num_heads"], sz["num_kv_heads"], sz["head_dim"]
    h = u.reshape(B * S, D)
    q = mm(h, wq, mode).reshape(B, S, H, hd)
    k = mm(h, wk, mode).reshape(B, S, K, hd).repeat_interleave(H // K, dim=2)
    v = mm(h, wv, mode).reshape(B, S, K, hd).repeat_interleave(H // K, dim=2)
    s = einsum("bqhd,bkhd->bhqk", q, k, mode) * sz["attn_scale"]
    causal = torch.ones(S, S, dtype=torch.bool, device=u.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    del s
    o = einsum("bhqk,bkhd->bqhd", p, v, mode).reshape(B * S, H * hd)
    return mm(o, wo, mode).reshape(B, S, D)


def swiglu(h, wg, wu, wd, mode):
    return mm(F.silu(mm(h, wg, mode)) * mm(h, wu, mode), wd, mode)


def moe(u, router, w_gate, w_up, w_down, sz, mode):
    """The routed experts of ``u`` (B, S, D), normed already: the softmax
    over each token's top ``experts_per_token`` router logits, and every
    routed pair computed, expert by expert over the tokens routed to it."""
    B, S, D = u.shape
    h = u.reshape(B * S, D)
    top, ids = mm(h, router, mode).topk(sz["experts_per_token"], dim=-1)
    gates = torch.softmax(top, dim=-1)
    y = torch.zeros_like(h)
    for e in range(sz["num_experts"]):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        if tok.numel():
            out = swiglu(h[tok], w_gate[e], w_up[e], w_down[e], mode)
            y.index_add_(0, tok, out * gates[tok, slot][:, None])
    return y.reshape(B, S, D)


def _layer(x, w: dict, mixer_kind, sz, mode):
    r, eps = sz["residual_multiplier"], sz["rms_eps"]
    u = rmsnorm(x, w["ln1.scale"], eps)
    if mixer_kind == "attn":
        y = attention(u, *(w[f"attn.{k}"] for k in ("wq", "wk", "wv", "wo")), sz, mode)
    else:
        y = mixer(u, *(w[f"mixer.{k}"] for k in MIXER_KEYS), sz, mode)
    x = x + r * y
    u = rmsnorm(x, w["ln2.scale"], eps)
    f = moe(u, w["ffn.router"], w["ffn.w_gate"], w["ffn.w_up"], w["ffn.w_down"], sz, mode)
    B, S, D = u.shape
    f = f + swiglu(u.reshape(B * S, D), w["ffn.shared.w_gate"], w["ffn.shared.w_up"],
                   w["ffn.shared.w_down"], mode).reshape(B, S, D)
    return x + r * f


def hidden(params: dict, tokens: torch.Tensor, sz: dict, mode="f32", remat=True):
    """tokens (B, S) -> the final RMSNorm's output (B, S, D), float32; with
    ``remat`` each layer is recomputed in the backward (memory only)."""
    x = params["embed"][tokens.long()] * sz["embed_multiplier"]
    for name, kind in layout(sz):
        w = {k[len(name) + 1:]: v for k, v in params.items() if k.startswith(name + ".")}
        if remat and torch.is_grad_enabled():
            x = checkpoint(_layer, x, w, kind, sz, mode, use_reentrant=False)
        else:
            x = _layer(x, w, kind, sz, mode)
    return rmsnorm(x, params["final_norm.scale"], sz["rms_eps"])


def head(params, sz):
    """The tied head with the logits' scaling folded in: (D, V)."""
    return params["embed"].T / sz["logits_scaling"]


def train_loss(params, batch, sz, mode="f32"):
    h = hidden(params, batch["tokens"], sz, mode)
    return cross_entropy(h, head(params, sz), batch["labels"], mode)


@torch.no_grad()
def logits(params, tokens, sz, mode="f32", start=0):
    """tokens (1, L) -> float32 logits (L - start, V) at positions start ..
    L-1: the full forward pass, no cache."""
    h = hidden(params, tokens, sz, mode, remat=False)[0, start:]
    return mm(h, head(params, sz), mode)
