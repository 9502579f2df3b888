"""Hybrid Mamba-2 + attention LM — the port of ``repro.models.hybrid``
(Jamba), and the layouts that a config states (Granite-4.0-H).

The model is a stack of blocks, each one period of the layer pattern
(``period``): each slot of a period is a layer of one mixer, attention or
Mamba-2, followed by its FFN, a dense MLP or an MoE (with a shared expert
where the config has one). Jamba's period is fixed (``cfg.layer_pattern``
empty): 8 slots, attention in slot 0 with a dense MLP, Mamba-2 in slots 1 …
7 with an MoE in the odd ones and a dense MLP in the even ones. A config
with a ``layer_pattern`` ("M" Mamba-2, "A" attention, one "A" a period)
has an MoE in every slot (Granite: ``MMMMMAMMMM``). The slots run in
period order; the attention slot is named ``attn``, Mamba-2 slot ``i``
``s{i}``, so Jamba's tree is the JAX package's.

The JAX package stacks the blocks on a leading axis and scans them, with
the heterogeneous slots unrolled inside the block body; here the blocks are
an ``nn.ModuleList`` and the scan is a loop over it. The attention slot
calls ``attention`` (the flash kernel under ``attn_impl="flash"``), the
mixers ``mamba_mixer`` (the SSD scan kernel's wrapper) and the MoE slots
``moe_apply`` (the router kernel's wrapper), so one block runs all three
model kernels. ``hybrid_forward``/``hybrid_train_loss`` are the training
path (differentiable, each block under ``_remat``); prefill and decode run
under ``torch.no_grad()``: the serving path. Granite's scalars (embedding
and residual multipliers, logit scaling, the rmsnorm's eps) are applied
where the config sets them; Jamba's are 1 and add no operation.

Attention layers carry the only KV cache (one a block), stacked
``(n_blocks, B, …)``; the mixers carry the O(1) recurrent state
``conv``/``state``, stacked ``(n_blocks, mamba slots a period, B, …)``:
the batch is axis 2 of those leaves.
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


def _n_blocks(cfg):
    assert cfg.num_layers % cfg.hybrid_period == 0
    return cfg.num_layers // cfg.hybrid_period


def _slot_is_moe(i, cfg):
    return cfg.is_moe and (i % cfg.moe_period == 1)  # odd slots → MoE


def period(cfg) -> list:
    """``[(mixer, ffn)]`` of each slot of one period, in order: mixer
    ``"attn"`` or ``"mamba"``, ffn ``"mlp"`` or ``"moe"``."""
    if not cfg.layer_pattern:  # jamba
        return [("attn", "mlp")] + [("mamba", "moe" if _slot_is_moe(i, cfg) else "mlp")
                                    for i in range(1, cfg.attn_period)]
    if cfg.layer_pattern.count("A") != 1 or set(cfg.layer_pattern) - {"A", "M"}:
        raise ValueError(f"{cfg.name}: layer_pattern {cfg.layer_pattern!r} is not one period "
                         f"of slots of 'M' and one 'A'")
    ffn = "moe" if cfg.is_moe else "mlp"
    return [("attn" if c == "A" else "mamba", ffn) for c in cfg.layer_pattern]


def mamba_slots(cfg) -> int:
    """Mamba-2 slots a period: the rows of a block's ``conv``/``state``."""
    return sum(m == "mamba" for m, _ in period(cfg))


def moe_layers(cfg) -> int:
    """The model's layers with an MoE FFN."""
    return _n_blocks(cfg) * sum(f == "moe" for _, f in period(cfg))


def _ffn_module(kind, cfg, dt, device, generator):
    if kind == "moe":
        return MoE(cfg, dt, device, generator)
    return MLP(cfg.d_model, cfg.d_ff, dt, device, generator)


class AttnSlot(nn.Module):
    def __init__(self, cfg, device, generator=None, ffn="mlp"):
        super().__init__()
        dt = _dtype(cfg)
        self.ln1 = Norm(cfg.d_model, cfg.norm_type, device)
        self.attn = attn.Attention(cfg, dt, device, generator)
        self.ln2 = Norm(cfg.d_model, cfg.norm_type, device)
        self.ffn = _ffn_module(ffn, cfg, dt, device, generator)


class MambaSlot(nn.Module):
    """Mamba slot ``i`` of a block; ``index`` is ``i`` and ``row`` its row
    of the block's ``conv``/``state`` caches (ints, not parameters)."""

    def __init__(self, cfg, i, row, device, generator=None, ffn="mlp"):
        super().__init__()
        self.index, self.row = i, row
        dt = _dtype(cfg)
        self.ln1 = Norm(cfg.d_model, cfg.norm_type, device)
        self.mixer = mamba2.Mamba2Mixer(cfg, dt, device, generator)
        self.ln2 = Norm(cfg.d_model, cfg.norm_type, device)
        self.ffn = _ffn_module(ffn, cfg, dt, device, generator)


class Block(nn.Module):
    """One period: ``attn`` (the attention slot) and ``s{i}`` (the mamba
    slots). The block functions run what a block holds, in period order
    (``layers``): a block without ``attn`` (None) or with fewer mamba slots
    (the dry run prices one slot at a time) runs the rest, each slot's FFN
    by its own kind."""

    def __init__(self, cfg, device, generator=None):
        super().__init__()
        rows = 0
        for i, (mixer, ffn) in enumerate(period(cfg)):
            if mixer == "attn":
                self.attn = AttnSlot(cfg, device, generator, ffn)
            else:
                self.add_module(f"s{i}", MambaSlot(cfg, i, rows, device, generator, ffn))
                rows += 1

    def slots(self):
        """The mamba slots."""
        return [m for m in self.children() if isinstance(m, MambaSlot)]

    def layers(self):
        """The slots it holds, in period order."""
        return [m for m in self.children() if isinstance(m, (AttnSlot, MambaSlot))]


class HybridLM(nn.Module):
    """``embed`` (V, D), ``lm_head`` (D, V) unless tied, ``blocks`` and
    ``final_norm`` — the JAX parameter tree with its block axis turned into
    a list. With a ``generator`` every weight is drawn on its device in
    ``param_dtype``; without one the weights are left uninitialised on
    ``device``."""

    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        dt = _dtype(cfg)
        if generator is not None:
            device = generator.device
        self.embed = weight((cfg.vocab_size, cfg.d_model), dt, device, generator, embed_init)
        if not cfg.tie_embeddings:
            self.lm_head = weight((cfg.d_model, cfg.vocab_size), dt, device, generator,
                                  embed_init)
        self.blocks = nn.ModuleList(Block(cfg, device, generator)
                                    for _ in range(_n_blocks(cfg)))
        self.final_norm = Norm(cfg.d_model, cfg.norm_type, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def make_hybrid_params(generator: torch.Generator, cfg) -> HybridLM:
    """Random weights drawn from ``generator``, on its device."""
    return HybridLM(cfg, generator=generator)


def _norm(x, p, cfg):
    return apply_norm(x, p, cfg.norm_type, cfg.rms_eps)


def _residual(x, y, cfg):
    """``x + y``, the branch ``y`` scaled by ``residual_multiplier`` first
    where the config sets one."""
    if cfg.residual_multiplier != 1.0:
        y = y * cfg.residual_multiplier
    return x + y


def _embed(params, tokens, cfg):
    x = params.embed[tokens.long()]
    return x * cfg.embed_multiplier if cfg.embed_multiplier != 1.0 else x


def _logits(h, params, cfg):
    logits = h[:, -1] @ head_matrix(params, cfg)
    return logits / cfg.logits_scaling if cfg.logits_scaling != 1.0 else logits


def _ffn_apply(x, sp, cfg, aux):
    h = _norm(x, sp.ln2, cfg)
    if isinstance(sp.ffn, MoE):
        m, a = moe_apply(h, sp.ffn, cfg)
        return _residual(x, m, cfg), aux + a
    return _residual(x, mlp(h, sp.ffn), cfg), aux


def _positions(x):
    B, S, _ = x.shape
    return torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)


def hybrid_forward(params, tokens, cfg):
    """tokens: (B, S) → (h (B, S, D), aux_loss summed over the MoE slots),
    differentiable."""
    x = _embed(params, tokens, cfg)
    pos = _positions(x)

    def block(x, aux, bp):
        for sp in bp.layers():
            if isinstance(sp, AttnSlot):
                y, _ = attn.attention(_norm(x, sp.ln1, cfg), sp.attn, cfg, pos)
            else:
                y, _t, _s = mamba2.mamba_mixer(_norm(x, sp.ln1, cfg), sp.mixer, cfg)
            x, aux = _ffn_apply(_residual(x, y, cfg), sp, cfg, aux)
        return x, aux

    step = _remat(block, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for bp in params.blocks:
        x, aux = step(x, aux, bp)
    return _norm(x, params.final_norm, cfg), aux


def hybrid_train_loss(params, batch, cfg):
    h, aux = hybrid_forward(params, batch["tokens"], cfg)
    head = head_matrix(params, cfg)
    if cfg.logits_scaling != 1.0:
        head = head / cfg.logits_scaling
    loss = lm_loss(h, head, batch["labels"], cfg.loss_chunk)
    return loss + 0.01 * aux


def make_hybrid_cache(cfg, batch, max_len, dtype=torch.bfloat16, device="cuda"):
    nb = _n_blocks(cfg)
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    kv = (nb, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    rows = mamba_slots(cfg)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "conv": torch.zeros((nb, rows, batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "state": torch.zeros((nb, rows, batch, cfg.ssm_heads, cfg.ssm_headdim,
                              cfg.ssm_state), dtype=torch.float32, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def hybrid_prefill(params, tokens, cfg, cache_len=None):
    """Returns (last logits, cache): ``k``/``v`` (n_blocks, B, Smax, K, hd)
    in the activations' dtype, zero beyond S; ``conv`` (n_blocks, mamba
    slots, B, width-1, conv_dim) and ``state`` (n_blocks, mamba slots, B,
    H, P, N) f32, the mixers' recurrent state; ``pos`` (B,) int32."""
    x = _embed(params, tokens, cfg)
    B, S, _ = x.shape
    pos = _positions(x)
    # each block writes its slots of the stacked caches (no cross-block op)
    cache = make_hybrid_cache(cfg, B, cache_len or S, dtype=x.dtype, device=x.device)
    for b, bp in enumerate(params.blocks):
        for sp in bp.layers():
            if isinstance(sp, AttnSlot):
                y, (k, v) = attn.attention(_norm(x, sp.ln1, cfg), sp.attn, cfg, pos)
                cache["k"][b, :, :S] = k
                cache["v"][b, :, :S] = v
            else:
                y, t, s = mamba2.mamba_mixer(_norm(x, sp.ln1, cfg), sp.mixer, cfg)
                cache["conv"][b, sp.row] = t
                cache["state"][b, sp.row] = s
            x, _ = _ffn_apply(_residual(x, y, cfg), sp, cfg, 0.0)
    logits = _logits(_norm(x, params.final_norm, cfg), params, cfg)
    cache["pos"] = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, cache


@torch.no_grad()
def hybrid_decode_step(params, cache, tokens, cfg):
    """One decode step. tokens: (B, 1). Returns (logits (B, V), cache): the
    ``k``/``v`` slabs written in place (one row per slot per block), the
    mixers' ``conv``/``state`` new tensors, as the JAX function returns."""
    x = _embed(params, tokens, cfg)
    pos = cache["pos"]
    convs, states = new_decode_state(cache, x.dtype)
    for b, bp in enumerate(params.blocks):
        for sp in bp.layers():
            if isinstance(sp, AttnSlot):
                y, _, _ = attn.decode_attention(_norm(x, sp.ln1, cfg), sp.attn, cfg, pos,
                                                cache["k"][b], cache["v"][b])
            else:
                j = sp.row
                y, convs[b, j], states[b, j] = mamba2.mamba_mixer_decode(
                    _norm(x, sp.ln1, cfg), sp.mixer, cfg, cache["conv"][b, j],
                    cache["state"][b, j])
            x, _ = _ffn_apply(_residual(x, y, cfg), sp, cfg, 0.0)
    logits = _logits(_norm(x, params.final_norm, cfg), params, cfg)
    return logits, {"k": cache["k"], "v": cache["v"], "conv": convs, "state": states,
                    "pos": pos + 1}
