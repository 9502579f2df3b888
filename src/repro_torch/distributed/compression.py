"""Gradient compression for the DP all-reduce (the port of
``repro.distributed.compression``).

Two schemes, both with error feedback (the residual of the lossy step is
added back next step, preserving convergence — Karimireddy et al.):

  int8   — per-tensor absmax scaling to int8 (4× fewer wire bytes on the
           gradient all-reduce); ``torch.round`` rounds half to even, as
           ``jnp.round`` does
  topk   — keep the top fraction by magnitude, as zeroing (dense layout):
           only the k-th largest magnitude of ``torch.topk`` is used, and
           ``>=`` keeps its ties, as in the JAX function

Gradients and error-feedback state map each parameter's name to a tensor.
A JAX leaf stacks the layers, so its "per tensor" is per stacked leaf: here
the layers' parameters of one path (``layers.<i>.attn.wq`` for every i; the
hybrid's ``blocks.<b>.…`` and the encoder-decoder's ``enc_layers.<i>.…`` and
``dec_layers.<i>.…`` alike) share one int8 scale and one top-k threshold, k
counted over all of them, as in the JAX function. The port runs on one card, so nothing is reduced
after the compression: ``launch/train.py --compression`` applies it to the
step's gradients as the JAX training loop does before its (sharding-induced)
reduce.
"""
from __future__ import annotations

import torch

from repro_torch.interop import leaf_of


def init_ef_state(params) -> dict:
    from repro_torch.optim.adamw import named_tensors

    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in named_tensors(params).items()}


def _leaf_groups(names) -> dict:
    """``{reference leaf: [names]}`` (``interop.leaf_of``): the layers'
    parameters of one path together, every other name alone."""
    groups: dict = {}
    for k in names:
        groups.setdefault(leaf_of(k)[0], []).append(k)
    return groups


def _quant_int8(gs):
    scale = torch.clamp_min(torch.stack([g.abs().max() for g in gs]).max(), 1e-12) / 127.0
    return [torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8).float() * scale
            for g in gs]


def _topk_mask(gs, frac):
    n = sum(g.numel() for g in gs)
    k = max(int(n * frac), 1)
    flat = torch.cat([g.reshape(-1) for g in gs]).abs()
    thresh = torch.topk(flat, k).values[-1]
    return [torch.where(g.abs() >= thresh, g, 0.0) for g in gs]


@torch.no_grad()
def compressed_grads(grads, ef_state, method: str = "int8", topk_frac: float = 0.05):
    """Returns (grads_compressed, new_ef_state), each ``{name: tensor}``."""
    if method not in ("int8", "topk", "none"):
        raise ValueError(method)
    out, ef = {}, {}
    for names in _leaf_groups(grads).values():
        gfs = [grads[k].float() + ef_state[k] for k in names]
        if method == "int8":
            gcs = _quant_int8(gfs)
        elif method == "topk":
            gcs = _topk_mask(gfs, topk_frac)
        else:
            gcs = gfs
        for k, gf, gc in zip(names, gfs, gcs):
            out[k] = gc.to(grads[k].dtype)
            ef[k] = gf - gc
    return out, ef
