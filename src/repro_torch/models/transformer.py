"""Decoder-only transformer LM, dense or MoE (the port of
``repro.models.transformer``): GQA (+qk-norm), RoPE, sliding-window and
local:global window patterns, logit soft-caps, MoE every layer (mixtral),
VLM patch prefix (internvl2).

The JAX package stacks layers on a leading axis and runs them with
``lax.scan``; here the layers are an ``nn.ModuleList`` and the scan is a
loop over it. ``lm_forward``/``lm_train_loss`` are the training path
(differentiable, each layer under ``_remat``'s checkpoint policy);
prefill and decode run under ``torch.no_grad()``: the serving path.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.models import attention as attn
from repro_torch.models.layers import MLP, Norm, apply_norm, embed_init, lm_loss, mlp, weight
from repro_torch.models.moe import MoE, moe_apply

#: width of the (stub) InternViT patch embeddings the VLM projects
VIT_DIM = 1024


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


class Layer(nn.Module):
    """One decoder layer; ``window`` is its attention window (an int, not a
    parameter: ``layer_windows(cfg)[i]`` for layer ``i``)."""

    def __init__(self, cfg, device, generator=None, window=None):
        super().__init__()
        self.window = int(attn.GLOBAL_WINDOW if window is None else window)
        self.ln1 = Norm(cfg.d_model, cfg.norm_type, device)
        self.attn = attn.Attention(cfg, _dtype(cfg), device, generator)
        self.ln2 = Norm(cfg.d_model, cfg.norm_type, device)
        if cfg.is_moe:
            self.ffn = MoE(cfg, _dtype(cfg), device, generator)
        else:
            self.ffn = MLP(cfg.d_model, cfg.d_ff, _dtype(cfg), device, generator)


def _ffn(h, lp, cfg):
    if cfg.is_moe:
        m, _ = moe_apply(h, lp.ffn, cfg)
        return m
    return mlp(h, lp.ffn)


class TransformerLM(nn.Module):
    """``embed`` (V, D), ``layers``, ``final_norm`` and, unless tied,
    ``lm_head`` (D, V) — the JAX parameter tree with its layer axis turned
    into a list, and ``vit_proj`` (VIT_DIM, D) for the VLM's patch prefix.
    With a ``generator`` every weight is drawn on its device,
    tensor by tensor in ``param_dtype`` (a full-width model is never held
    in f32); without one the weights are left uninitialised on ``device``."""

    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        dt = _dtype(cfg)
        if generator is not None:
            device = generator.device
        self.embed = weight((cfg.vocab_size, cfg.d_model), dt, device, generator, embed_init)
        self.layers = nn.ModuleList(Layer(cfg, device, generator, w)
                                    for w in layer_windows(cfg).tolist())
        self.final_norm = Norm(cfg.d_model, cfg.norm_type, device)
        if not cfg.tie_embeddings:
            self.lm_head = weight((cfg.d_model, cfg.vocab_size), dt, device, generator,
                                  embed_init)
        if cfg.frontend == "vit_patch":
            self.vit_proj = weight((VIT_DIM, cfg.d_model), dt, device, generator, embed_init)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def make_lm_params(generator: torch.Generator, cfg) -> TransformerLM:
    """Random weights drawn from ``generator``, on its device."""
    return TransformerLM(cfg, generator=generator)


def head_matrix(params, cfg):
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def layer_windows(cfg) -> np.ndarray:
    """Static per-layer attention window (GLOBAL_WINDOW = unbounded)."""
    n = cfg.num_layers
    if cfg.local_global_period:
        per = cfg.local_global_period
        w = [cfg.local_window if (i + 1) % (per + 1) else attn.GLOBAL_WINDOW for i in range(n)]
    elif cfg.sliding_window:
        w = [cfg.sliding_window] * n
    else:
        w = [attn.GLOBAL_WINDOW] * n
    return np.asarray(w, np.int32)


def embed_tokens(params, tokens, cfg, patches=None):
    x = params.embed[tokens.long()]
    if patches is not None:  # VLM: project + prepend patch embeddings
        pe = patches.to(x.dtype) @ params.vit_proj
        x = torch.cat([pe, x], dim=1)
    return x


#: the products ``remat="dots"`` keeps: matmuls without batch dimensions
#: (``x @ w`` of a weight), as ``dots_with_no_batch_dims_saveable`` keeps
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(f, cfg):
    """``f`` under the config's checkpoint policy when a graph is recorded:
    ``full`` recomputes the whole layer in the backward (``jax.checkpoint``),
    ``dots`` keeps the weight products and recomputes the rest (the JAX
    ``dots_with_no_batch_dims_saveable`` policy), ``none`` keeps it all."""
    if cfg.remat == "none":
        return f
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _save_dots)
    elif cfg.remat != "full":
        raise ValueError(f"remat {cfg.remat!r}")

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return f(*args)
        return checkpoint(f, *args, use_reentrant=False, **kw)

    return wrapped


# ---------------------------------------------------------------------------
# forward (train)
# ---------------------------------------------------------------------------


def lm_forward(params, tokens, cfg, patches=None):
    """tokens: (B, S_text) → (h (B, S, D), aux_loss), differentiable; S
    includes the ``patches`` prefix. Flash stays eligible by
    ``lm_prefill``'s rule: every layer has one window."""
    x = embed_tokens(params, tokens, cfg, patches)
    B, S, _ = x.shape
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    warr = layer_windows(cfg)
    static = bool((warr == warr[0]).all())

    def layer(x, aux, lp, window):
        a, _ = attn.attention(apply_norm(x, lp.ln1, cfg.norm_type), lp.attn, cfg, pos,
                              window=window, static_window=static)
        x = x + a
        h = apply_norm(x, lp.ln2, cfg.norm_type)
        if cfg.is_moe:
            m, a_loss = moe_apply(h, lp.ffn, cfg)
            aux = aux + a_loss
        else:
            m = mlp(h, lp.ffn)
        return x + m, aux

    step = _remat(layer, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params.layers:
        x, aux = step(x, aux, lp, lp.window)
    return apply_norm(x, params.final_norm, cfg.norm_type), aux


def lm_train_loss(params, batch, cfg):
    """The mean next-token cross-entropy of ``batch`` (``tokens``,
    ``labels``; labels below 0 are masked; the VLM's ``patches`` prefix
    takes no loss) plus 0.01 x the MoE aux loss."""
    patches = batch.get("patches")
    h, aux = lm_forward(params, batch["tokens"], cfg, patches)
    labels = batch["labels"]
    if patches is not None:  # no loss on the patch prefix
        pad = torch.full((labels.shape[0], patches.shape[1]), -1, dtype=labels.dtype,
                         device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    loss = lm_loss(h, head_matrix(params, cfg), labels, cfg.loss_chunk)
    return loss + 0.01 * aux


@torch.no_grad()
def lm_prefill(params, tokens, cfg, cache_len=None, patches=None):
    """Run the prompt (after the ``patches`` prefix, if any), build KV
    caches sized ``cache_len`` (≥ S, the prefix included).

    Returns (last-position logits (B, V), cache dict): ``k``/``v``
    (L, B, Smax, K, hd) in the activations' dtype, zero beyond S, and
    ``pos`` (B,) int32.
    """
    x = embed_tokens(params, tokens, cfg, patches)
    B, S, _ = x.shape
    Smax = cache_len or S
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    warr = layer_windows(cfg)
    # the flash kernel stays eligible only when every layer has one window
    static = bool((warr == warr[0]).all())
    shape = (cfg.num_layers, B, Smax, cfg.num_kv_heads, cfg.head_dim)
    ks = torch.zeros(shape, dtype=x.dtype, device=x.device)
    vs = torch.zeros(shape, dtype=x.dtype, device=x.device)
    for i, lp in enumerate(params.layers):
        a, (k, v) = attn.attention(apply_norm(x, lp.ln1, cfg.norm_type), lp.attn, cfg,
                                   pos, window=lp.window, static_window=static)
        x = x + a
        h = apply_norm(x, lp.ln2, cfg.norm_type)
        x = x + _ffn(h, lp, cfg)
        ks[i, :, :S] = k
        vs[i, :, :S] = v
    h = apply_norm(x, params.final_norm, cfg.norm_type)
    logits = h[:, -1] @ head_matrix(params, cfg)
    cache = {"k": ks, "v": vs, "pos": torch.full((B,), S, dtype=torch.int32, device=x.device)}
    return logits, cache


def make_cache(cfg, batch, max_len, dtype=torch.bfloat16, device="cuda"):
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def lm_decode_step(params, cache, tokens, cfg):
    """One decode step. tokens: (B, 1); cache['pos']: (B,) write positions.

    Returns (logits (B, V), cache). The caches' ``k``/``v`` are written in
    place (one row per slot per layer); ``pos`` is a new tensor.
    """
    x = embed_tokens(params, tokens, cfg)
    pos = cache["pos"]
    for i, lp in enumerate(params.layers):
        a, _, _ = attn.decode_attention(apply_norm(x, lp.ln1, cfg.norm_type), lp.attn, cfg,
                                        pos, cache["k"][i], cache["v"][i], window=lp.window)
        x = x + a
        h = apply_norm(x, lp.ln2, cfg.norm_type)
        x = x + _ffn(h, lp, cfg)
    h = apply_norm(x, params.final_norm, cfg.norm_type)
    logits = h[:, -1] @ head_matrix(params, cfg)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
