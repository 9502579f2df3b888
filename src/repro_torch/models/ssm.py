"""Attention-free SSM LM (mamba2-780m): embed → N × (norm + mamba2 mixer) →
head (the port of ``repro.models.ssm``).

Decode state is O(1): per-layer (conv_tail, ssm_state) — no KV cache. The
JAX package scans the stacked layers; here they are an ``nn.ModuleList``
and the scan is a loop. ``ssm_forward``/``ssm_train_loss`` are the
training path (differentiable, each layer under ``_remat``); prefill and
decode run under ``torch.no_grad()``: the serving path.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import mamba2
from repro_torch.models.layers import Norm, apply_norm, embed_init, lm_loss, weight
from repro_torch.models.transformer import _dtype, _remat, head_matrix


class SSMLayer(nn.Module):
    def __init__(self, cfg, device, generator=None):
        super().__init__()
        self.ln = Norm(cfg.d_model, cfg.norm_type, device)
        self.mixer = mamba2.Mamba2Mixer(cfg, _dtype(cfg), device, generator)


class SSMLM(nn.Module):
    """``embed`` (V, D), ``layers[i].{ln, mixer}``, ``final_norm`` and, unless
    tied, ``lm_head`` (D, V) — the JAX parameter tree with its layer axis
    turned into a list. With a ``generator`` every weight is drawn on its
    device in ``param_dtype``; without one the weights are left
    uninitialised on ``device``."""

    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        dt = _dtype(cfg)
        if generator is not None:
            device = generator.device
        self.embed = weight((cfg.vocab_size, cfg.d_model), dt, device, generator, embed_init)
        self.layers = nn.ModuleList(SSMLayer(cfg, device, generator)
                                    for _ in range(cfg.num_layers))
        self.final_norm = Norm(cfg.d_model, cfg.norm_type, device)
        if not cfg.tie_embeddings:
            self.lm_head = weight((cfg.d_model, cfg.vocab_size), dt, device, generator,
                                  embed_init)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def make_ssm_params(generator: torch.Generator, cfg) -> SSMLM:
    """Random weights drawn from ``generator``, on its device."""
    return SSMLM(cfg, generator=generator)


def ssm_forward(params, tokens, cfg):
    """tokens: (B, S) → h (B, S, D), differentiable."""
    x = params.embed[tokens.long()]

    def layer(x, lp):
        y, _tail, _st = mamba2.mamba_mixer(apply_norm(x, lp.ln, cfg.norm_type), lp.mixer, cfg)
        return x + y

    step = _remat(layer, cfg)
    for lp in params.layers:
        x = step(x, lp)
    return apply_norm(x, params.final_norm, cfg.norm_type)


def ssm_train_loss(params, batch, cfg):
    h = ssm_forward(params, batch["tokens"], cfg)
    return lm_loss(h, head_matrix(params, cfg), batch["labels"], cfg.loss_chunk)


def make_ssm_cache(cfg, batch, dtype=torch.bfloat16, device="cuda"):
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "conv": torch.zeros((cfg.num_layers, batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "state": torch.zeros((cfg.num_layers, batch, cfg.ssm_heads, cfg.ssm_headdim,
                              cfg.ssm_state), dtype=torch.float32, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def ssm_prefill(params, tokens, cfg):
    """Returns (last logits, cache) — the cache is the O(1) recurrent state:
    ``conv`` (L, B, width-1, conv_dim) in the activations' dtype, ``state``
    (L, B, H, P, N) f32, ``pos`` (B,) int32."""
    x = params.embed[tokens.long()]
    B = tokens.shape[0]
    # each layer writes its slot of the stacked state (no cross-layer op)
    cache = make_ssm_cache(cfg, B, dtype=x.dtype, device=x.device)
    for i, lp in enumerate(params.layers):
        y, tail, st = mamba2.mamba_mixer(apply_norm(x, lp.ln, cfg.norm_type), lp.mixer, cfg)
        x = x + y
        cache["conv"][i] = tail
        cache["state"][i] = st
    h = apply_norm(x, params.final_norm, cfg.norm_type)
    logits = h[:, -1] @ head_matrix(params, cfg)
    cache["pos"] = torch.full((B,), tokens.shape[1], dtype=torch.int32, device=x.device)
    return logits, cache


@torch.no_grad()
def ssm_decode_step(params, cache, tokens, cfg):
    """One decode step. tokens: (B, 1). Returns (logits (B, V), a new cache
    dict), as the JAX function returns one."""
    x = params.embed[tokens.long()]  # (B, 1, D)
    convs, states = new_decode_state(cache, x.dtype)
    for i, lp in enumerate(params.layers):
        y, convs[i], states[i] = mamba2.mamba_mixer_decode(
            apply_norm(x, lp.ln, cfg.norm_type), lp.mixer, cfg, cache["conv"][i],
            cache["state"][i])
        x = x + y
    h = apply_norm(x, params.final_norm, cfg.norm_type)
    logits = h[:, -1] @ head_matrix(params, cfg)
    return logits, {"conv": convs, "state": states, "pos": cache["pos"] + 1}


def new_decode_state(cache, act_dtype):
    """Unwritten tensors for a decode step's new ``conv``/``state`` (each
    layer writes its slot): the conv window in the promoted dtype of the
    cache and the activations, the state in f32 or wider, as
    ``mamba_mixer_decode`` returns them."""
    conv, state = cache["conv"], cache["state"]
    return (torch.empty(conv.shape, dtype=torch.promote_types(conv.dtype, act_dtype),
                        device=conv.device),
            torch.empty(state.shape, dtype=torch.promote_types(state.dtype, torch.float32),
                        device=state.device))
