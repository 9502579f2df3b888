"""Jamba-style hybrid: period-8 blocks (1 attention + 7 mamba layers), each
layer followed by a dense MLP or an MoE FFN (alternating) — the port of
``repro.models.hybrid``.

The JAX package stacks the blocks on a leading axis and scans them, with the
8 heterogeneous slots unrolled inside the block body; here the blocks are an
``nn.ModuleList`` and the scan is a loop over it. The attention slot calls
``attention`` (the flash kernel under ``attn_impl="flash"``), the mixers
``mamba_mixer`` (the SSD scan kernel's wrapper) and the MoE slots
``moe_apply`` (the router kernel's wrapper), so one block runs all three
model kernels. ``hybrid_forward``/``hybrid_train_loss`` are the training
path (differentiable, each block under ``_remat``); prefill and decode run
under ``torch.no_grad()``: the serving path.

Attention layers carry the only KV cache (1/8 of layers); the mixers carry
the O(1) recurrent state ``conv``/``state``, stacked ``(n_blocks, 7, B,
…)``: the batch is axis 2 of those leaves.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models.layers import MLP, Norm, apply_norm, embed_init, lm_loss, mlp, weight
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.models.ssm import new_decode_state
from repro_torch.models.transformer import _dtype, _remat, head_matrix

N_SLOTS = 8  # cfg.attn_period


def _n_blocks(cfg):
    assert cfg.num_layers % cfg.attn_period == 0
    return cfg.num_layers // cfg.attn_period


def _slot_is_moe(i, cfg):
    return cfg.is_moe and (i % cfg.moe_period == 1)  # odd slots → MoE


class AttnSlot(nn.Module):
    def __init__(self, cfg, device, generator=None):
        super().__init__()
        dt = _dtype(cfg)
        self.ln1 = Norm(cfg.d_model, cfg.norm_type, device)
        self.attn = attn.Attention(cfg, dt, device, generator)
        self.ln2 = Norm(cfg.d_model, cfg.norm_type, device)
        self.ffn = MLP(cfg.d_model, cfg.d_ff, dt, device, generator)


class MambaSlot(nn.Module):
    """Mamba slot ``i`` (1 … 7) of a block; ``index`` is ``i`` (an int, not
    a parameter): its row of the block's ``conv``/``state`` caches."""

    def __init__(self, cfg, i, device, generator=None):
        super().__init__()
        self.index = i
        dt = _dtype(cfg)
        self.ln1 = Norm(cfg.d_model, cfg.norm_type, device)
        self.mixer = mamba2.Mamba2Mixer(cfg, dt, device, generator)
        self.ln2 = Norm(cfg.d_model, cfg.norm_type, device)
        self.ffn = (MoE(cfg, dt, device, generator) if _slot_is_moe(i, cfg)
                    else MLP(cfg.d_model, cfg.d_ff, dt, device, generator))


class Block(nn.Module):
    """``attn`` (the attention slot) and ``s1`` … ``s7`` (the mamba slots).
    The block functions run what a block holds: a block without ``attn``
    (None) or with fewer mamba slots (the dry run prices one slot at a
    time) runs the rest, each slot's FFN by its own kind."""

    def __init__(self, cfg, device, generator=None):
        super().__init__()
        self.attn = AttnSlot(cfg, device, generator)
        for i in range(1, N_SLOTS):
            self.add_module(f"s{i}", MambaSlot(cfg, i, device, generator))

    def slots(self):
        return [getattr(self, f"s{i}") for i in range(1, N_SLOTS)]


class HybridLM(nn.Module):
    """``embed`` (V, D), ``lm_head`` (D, V), ``blocks`` and ``final_norm`` —
    the JAX parameter tree with its block axis turned into a list. With a
    ``generator`` every weight is drawn on its device in ``param_dtype``;
    without one the weights are left uninitialised on ``device``."""

    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        dt = _dtype(cfg)
        if generator is not None:
            device = generator.device
        self.embed = weight((cfg.vocab_size, cfg.d_model), dt, device, generator, embed_init)
        self.lm_head = weight((cfg.d_model, cfg.vocab_size), dt, device, generator, embed_init)
        self.blocks = nn.ModuleList(Block(cfg, device, generator)
                                    for _ in range(_n_blocks(cfg)))
        self.final_norm = Norm(cfg.d_model, cfg.norm_type, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def make_hybrid_params(generator: torch.Generator, cfg) -> HybridLM:
    """Random weights drawn from ``generator``, on its device."""
    return HybridLM(cfg, generator=generator)


def _ffn_apply(x, sp, cfg, aux):
    h = apply_norm(x, sp.ln2, cfg.norm_type)
    if isinstance(sp.ffn, MoE):
        m, a = moe_apply(h, sp.ffn, cfg)
        return x + m, aux + a
    return x + mlp(h, sp.ffn), aux


def _attn_slot(x, ap, cfg, pos):
    """The attention slot: (x after attention and its MLP, (k, v))."""
    a, kv = attn.attention(apply_norm(x, ap.ln1, cfg.norm_type), ap.attn, cfg, pos)
    x = x + a
    return x + mlp(apply_norm(x, ap.ln2, cfg.norm_type), ap.ffn), kv


def _positions(x):
    B, S, _ = x.shape
    return torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)


def hybrid_forward(params, tokens, cfg):
    """tokens: (B, S) → (h (B, S, D), aux_loss summed over the MoE slots),
    differentiable."""
    x = params.embed[tokens.long()]
    pos = _positions(x)

    def block(x, aux, bp):
        if bp.attn is not None:
            x, _ = _attn_slot(x, bp.attn, cfg, pos)
        for sp in bp.slots():
            y, _t, _s = mamba2.mamba_mixer(apply_norm(x, sp.ln1, cfg.norm_type), sp.mixer, cfg)
            x, aux = _ffn_apply(x + y, sp, cfg, aux)
        return x, aux

    step = _remat(block, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for bp in params.blocks:
        x, aux = step(x, aux, bp)
    return apply_norm(x, params.final_norm, cfg.norm_type), aux


def hybrid_train_loss(params, batch, cfg):
    h, aux = hybrid_forward(params, batch["tokens"], cfg)
    loss = lm_loss(h, head_matrix(params, cfg), batch["labels"], cfg.loss_chunk)
    return loss + 0.01 * aux


def make_hybrid_cache(cfg, batch, max_len, dtype=torch.bfloat16, device="cuda"):
    nb = _n_blocks(cfg)
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    kv = (nb, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "conv": torch.zeros((nb, N_SLOTS - 1, batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "state": torch.zeros((nb, N_SLOTS - 1, batch, cfg.ssm_heads, cfg.ssm_headdim,
                              cfg.ssm_state), dtype=torch.float32, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def hybrid_prefill(params, tokens, cfg, cache_len=None):
    """Returns (last logits, cache): ``k``/``v`` (n_blocks, B, Smax, K, hd)
    in the activations' dtype, zero beyond S; ``conv`` (n_blocks, 7, B,
    width-1, conv_dim) and ``state`` (n_blocks, 7, B, H, P, N) f32, the
    mixers' recurrent state; ``pos`` (B,) int32."""
    x = params.embed[tokens.long()]
    B, S, _ = x.shape
    pos = _positions(x)
    # each block writes its slots of the stacked caches (no cross-block op)
    cache = make_hybrid_cache(cfg, B, cache_len or S, dtype=x.dtype, device=x.device)
    for b, bp in enumerate(params.blocks):
        if bp.attn is not None:
            x, (k, v) = _attn_slot(x, bp.attn, cfg, pos)
            cache["k"][b, :, :S] = k
            cache["v"][b, :, :S] = v
        for sp in bp.slots():
            y, t, s = mamba2.mamba_mixer(apply_norm(x, sp.ln1, cfg.norm_type), sp.mixer, cfg)
            cache["conv"][b, sp.index - 1] = t
            cache["state"][b, sp.index - 1] = s
            x, _ = _ffn_apply(x + y, sp, cfg, 0.0)
    h = apply_norm(x, params.final_norm, cfg.norm_type)
    logits = h[:, -1] @ head_matrix(params, cfg)
    cache["pos"] = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, cache


@torch.no_grad()
def hybrid_decode_step(params, cache, tokens, cfg):
    """One decode step. tokens: (B, 1). Returns (logits (B, V), cache): the
    ``k``/``v`` slabs written in place (one row per slot per block), the
    mixers' ``conv``/``state`` new tensors, as the JAX function returns."""
    x = params.embed[tokens.long()]
    pos = cache["pos"]
    convs, states = new_decode_state(cache, x.dtype)
    for b, bp in enumerate(params.blocks):
        ap = bp.attn
        if ap is not None:
            a, _, _ = attn.decode_attention(apply_norm(x, ap.ln1, cfg.norm_type), ap.attn,
                                            cfg, pos, cache["k"][b], cache["v"][b])
            x = x + a
            x = x + mlp(apply_norm(x, ap.ln2, cfg.norm_type), ap.ffn)
        for sp in bp.slots():
            j = sp.index - 1
            y, convs[b, j], states[b, j] = mamba2.mamba_mixer_decode(
                apply_norm(x, sp.ln1, cfg.norm_type), sp.mixer, cfg, cache["conv"][b, j],
                cache["state"][b, j])
            x, _ = _ffn_apply(x + y, sp, cfg, 0.0)
    h = apply_norm(x, params.final_norm, cfg.norm_type)
    logits = h[:, -1] @ head_matrix(params, cfg)
    return logits, {"k": cache["k"], "v": cache["v"], "conv": convs, "state": states,
                    "pos": pos + 1}
