"""Whisper-style encoder-decoder (the port of ``repro.models.encdec``). The
audio conv frontend is a STUB: callers supply precomputed frame embeddings
(B, S_enc, D); ``conv_frontend_stub`` is a tiny stand-in for smoke tests.

Decoder positions are a learned table sized to the requested decode length
(the model zoo sizes it to its largest decode cell, past whisper's
published 448 cap — a table extension, not retraining).

The JAX package stacks each side's layers and scans them; here they are two
``nn.ModuleList``s and the scans are loops. The encoder's attention is
non-causal; each decoder layer has causal self-attention, then
cross-attention on the encoder output (``attention(..., kv=enc_out,
causal=False)``), each through the flash kernel under
``attn_impl="flash"``. At decode the cross-attention is the plain
``attend`` against the cached ``k_cross``/``v_cross``, as in the JAX
package: decode launches no flash. ``encode``/``decode_train``/
``encdec_train_loss`` are the training path (differentiable, each layer
under ``_remat``); prefill and decode run under ``torch.no_grad()``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.layers import Norm, apply_norm, embed_init, lm_loss, weight
from repro_torch.models.transformer import _dtype, _remat


class GeluMLP(nn.Module):
    """whisper's two-matrix GELU MLP: ``w1`` (d, f), ``w2`` (f, d) in the
    parameter dtype, biases ``b1`` (f,), ``b2`` (d,) in f32 (zeros) — the
    JAX package's ``make_gelu_mlp_params``."""

    def __init__(self, d, f, dtype, device=None, generator=None):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.w1 = weight((d, f), dtype, device, generator)
        self.b1 = nn.Parameter(torch.zeros(f, **f32))
        self.w2 = weight((f, d), dtype, device, generator)
        self.b2 = nn.Parameter(torch.zeros(d, **f32))


def gelu_mlp(x, p):
    # jax.nn.gelu is the tanh approximation by default
    h = F.gelu(x @ p.w1 + p.b1.to(x.dtype), approximate="tanh")
    return h @ p.w2 + p.b2.to(x.dtype)


class EncLayer(nn.Module):
    def __init__(self, cfg, device, generator=None):
        super().__init__()
        dt = _dtype(cfg)
        self.ln1 = Norm(cfg.d_model, cfg.norm_type, device)
        self.attn = attn.Attention(cfg, dt, device, generator)
        self.ln2 = Norm(cfg.d_model, cfg.norm_type, device)
        self.ffn = GeluMLP(cfg.d_model, cfg.d_ff, dt, device, generator)


class DecLayer(nn.Module):
    def __init__(self, cfg, device, generator=None):
        super().__init__()
        dt = _dtype(cfg)
        self.ln1 = Norm(cfg.d_model, cfg.norm_type, device)
        self.self_attn = attn.Attention(cfg, dt, device, generator)
        self.lnx = Norm(cfg.d_model, cfg.norm_type, device)
        self.cross_attn = attn.Attention(cfg, dt, device, generator)
        self.ln2 = Norm(cfg.d_model, cfg.norm_type, device)
        self.ffn = GeluMLP(cfg.d_model, cfg.d_ff, dt, device, generator)


class EncDecLM(nn.Module):
    """``embed`` (V, D; tied as the head), ``pos_dec`` (max_dec, D),
    ``pos_enc`` (max_enc, D), ``enc_layers``, ``enc_norm``, ``dec_layers``,
    ``dec_norm`` — the JAX parameter tree with its layer axes turned into
    lists. With a ``generator`` every weight is drawn on its device in
    ``param_dtype``; without one the weights are left uninitialised on
    ``device``."""

    def __init__(self, cfg, device=None, generator=None, max_dec=None, max_enc=None):
        super().__init__()
        dt = _dtype(cfg)
        if generator is not None:
            device = generator.device
        max_dec = max_dec or 448
        max_enc = max_enc or cfg.enc_seq
        self.embed = weight((cfg.vocab_size, cfg.d_model), dt, device, generator, embed_init)
        self.pos_dec = weight((max_dec, cfg.d_model), dt, device, generator, embed_init)
        self.pos_enc = weight((max_enc, cfg.d_model), dt, device, generator, embed_init)
        self.enc_layers = nn.ModuleList(EncLayer(cfg, device, generator)
                                        for _ in range(cfg.enc_layers))
        self.enc_norm = Norm(cfg.d_model, cfg.norm_type, device)
        self.dec_layers = nn.ModuleList(DecLayer(cfg, device, generator)
                                        for _ in range(cfg.num_layers))
        self.dec_norm = Norm(cfg.d_model, cfg.norm_type, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def make_encdec_params(generator: torch.Generator, cfg, max_dec=None, max_enc=None):
    """Random weights drawn from ``generator``, on its device."""
    return EncDecLM(cfg, generator=generator, max_dec=max_dec, max_enc=max_enc)


def conv_frontend_stub(audio, cfg):
    """Smoke-test-only stand-in for whisper's mel+conv frontend: strided avg
    pooling of raw features into (B, S/2, D)."""
    B, S = audio.shape[0], audio.shape[1]
    x = audio.reshape(B, S // 2, -1)
    d = x.shape[-1]
    if d < cfg.d_model:
        x = F.pad(x, (0, cfg.d_model - d))
    return x[..., :cfg.d_model]


def _positions(B, S, device):
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def encode(params, frames, cfg):
    """frames: (B, S_enc, D) precomputed frame embeddings (frontend stub), in
    the weights' dtype. Frames of another dtype are refused: the JAX
    function runs the encoder in the wider of the two dtypes, which a torch
    matmul of mixed dtypes does not do."""
    if frames.dtype != params.pos_enc.dtype:
        raise TypeError(f"encode: frames are {frames.dtype}, the weights "
                        f"{params.pos_enc.dtype}; cast the frames to the weights' dtype")
    B, S = frames.shape[0], frames.shape[1]
    x = frames + params.pos_enc[None, :S]
    pos = _positions(B, S, x.device)

    def layer(x, lp):
        a, _ = attn.attention(apply_norm(x, lp.ln1, cfg.norm_type), lp.attn, cfg, pos,
                              causal=False)
        x = x + a
        return x + gelu_mlp(apply_norm(x, lp.ln2, cfg.norm_type), lp.ffn)

    step = _remat(layer, cfg)
    for lp in params.enc_layers:
        x = step(x, lp)
    return apply_norm(x, params.enc_norm, cfg.norm_type)


def _dec_embed(params, tokens):
    S = tokens.shape[1]
    return params.embed[tokens.long()] + params.pos_dec[None, :S]


def decode_train(params, tokens, enc_out, cfg):
    x = _dec_embed(params, tokens)
    pos = _positions(*tokens.shape, x.device)

    def layer(x, enc_out, lp):
        a, _ = attn.attention(apply_norm(x, lp.ln1, cfg.norm_type), lp.self_attn, cfg, pos)
        x = x + a
        c, _ = attn.attention(apply_norm(x, lp.lnx, cfg.norm_type), lp.cross_attn, cfg, pos,
                              kv=enc_out, causal=False)
        x = x + c
        return x + gelu_mlp(apply_norm(x, lp.ln2, cfg.norm_type), lp.ffn)

    step = _remat(layer, cfg)
    for lp in params.dec_layers:
        x = step(x, enc_out, lp)
    return apply_norm(x, params.dec_norm, cfg.norm_type)


def encdec_train_loss(params, batch, cfg):
    enc_out = encode(params, batch["frames"], cfg)
    h = decode_train(params, batch["tokens"], enc_out, cfg)
    return lm_loss(h, params.embed.T, batch["labels"], cfg.loss_chunk)


@torch.no_grad()
def encdec_prefill(params, frames, tokens, cfg, cache_len=None):
    """Encode audio, precompute cross K/V, prefill the decoder prompt.
    Returns (last logits, cache): ``k``/``v`` (L, B, Smax, K, hd), zero
    beyond S; ``k_cross``/``v_cross`` (L, B, S_enc, K, hd); ``pos`` and
    ``enc_len`` (B,) int32."""
    enc_out = encode(params, frames, cfg)
    B, S = tokens.shape
    Smax = cache_len or S
    x = _dec_embed(params, tokens)
    pos = _positions(B, S, x.device)
    Senc = enc_out.shape[1]
    # each layer writes its slots of the stacked caches (no cross-layer op)
    cache = make_encdec_cache(cfg, B, Smax, Senc, dtype=x.dtype, device=x.device)
    for i, lp in enumerate(params.dec_layers):
        a, (k, v) = attn.attention(apply_norm(x, lp.ln1, cfg.norm_type), lp.self_attn, cfg,
                                   pos)
        x = x + a
        c, (kx, vx) = attn.attention(apply_norm(x, lp.lnx, cfg.norm_type), lp.cross_attn,
                                     cfg, pos, kv=enc_out, causal=False)
        x = x + c
        x = x + gelu_mlp(apply_norm(x, lp.ln2, cfg.norm_type), lp.ffn)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
        cache["k_cross"][i] = kx
        cache["v_cross"][i] = vx
    h = apply_norm(x, params.dec_norm, cfg.norm_type)
    logits = h[:, -1] @ params.embed.T
    cache["pos"] = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, cache


def make_encdec_cache(cfg, batch, max_len, enc_len, dtype=torch.bfloat16, device="cuda"):
    L = cfg.num_layers
    kv = (L, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    kvx = (L, batch, enc_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "k_cross": torch.zeros(kvx, dtype=dtype, device=device),
        "v_cross": torch.zeros(kvx, dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        "enc_len": torch.full((batch,), enc_len, dtype=torch.int32, device=device),
    }


@torch.no_grad()
def encdec_decode_step(params, cache, tokens, cfg):
    """One decode step. tokens: (B, 1). Returns (logits (B, V), cache): the
    self-attention ``k``/``v`` written in place, ``pos`` a new tensor, the
    rest of the cache as it was."""
    B = tokens.shape[0]
    pos = cache["pos"]
    x = params.embed[tokens.long()] + params.pos_dec[pos.long()][:, None, :]
    Senc = cache["k_cross"].shape[2]
    pos_kv_x = _positions(B, Senc, x.device)
    for i, lp in enumerate(params.dec_layers):
        a, _, _ = attn.decode_attention(apply_norm(x, lp.ln1, cfg.norm_type), lp.self_attn,
                                        cfg, pos, cache["k"][i], cache["v"][i])
        x = x + a
        # cross attention against the precomputed encoder K/V
        h = apply_norm(x, lp.lnx, cfg.norm_type)
        q = (h @ lp.cross_attn.wq).reshape(B, 1, cfg.num_heads, cfg.head_dim)
        o = attn.attend(q, cache["k_cross"][i], cache["v_cross"][i], pos[:, None], pos_kv_x,
                        causal=False)
        x = x + attn._promote(o.reshape(B, 1, cfg.q_dim), lp.cross_attn.wo)
        x = x + gelu_mlp(apply_norm(x, lp.ln2, cfg.norm_type), lp.ffn)
    h = apply_norm(x, params.dec_norm, cfg.norm_type)
    logits = h[:, -1] @ params.embed.T
    return logits, {**cache, "pos": pos + 1}
