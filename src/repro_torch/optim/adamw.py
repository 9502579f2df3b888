"""AdamW on tensors (the port of ``repro.optim.adamw``; no ``torch.optim``).

Moments are stored in a configurable dtype (f32 by default; bf16 where a
config asks for it) and updated in f32, with ``weight_decay·p`` inside the
update after bias correction, as the JAX function does. The state is the
reference's ``{"m", "v", "step"}``: ``m`` and ``v`` map each parameter's
name to its moment, ``step`` is a 0-d int32 tensor.

One deliberate difference: ``adamw_update`` writes the new parameters and
moments into the existing tensors (under ``torch.no_grad()``), where the
JAX function returns new arrays; the returned state holds those tensors
and a new ``step``.
"""
from __future__ import annotations

import torch
from torch import nn


def named_tensors(params) -> dict:
    """``{name: tensor}`` of a module's parameters, or ``params`` itself
    when it is already such a mapping."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt_state(params, moment_dtype=torch.float32) -> dict:
    named = named_tensors(params)
    dev = next(iter(named.values())).device if named else None
    return {
        "m": {k: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
              for k, p in named.items()},
        "v": {k: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
              for k, p in named.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


@torch.no_grad()
def adamw_update(grads, opt_state, params, lr=3e-4, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1):
    """Returns (params, new_opt_state); ``grads`` maps each parameter's name
    to its gradient, ``lr`` is a number or a 0-d tensor. The parameters and
    moments are updated in place."""
    named = named_tensors(params)
    step = opt_state["step"] + 1
    sf = step.float()
    c1 = 1.0 - torch.pow(b1, sf)
    c2 = 1.0 - torch.pow(b2, sf)
    for k, p in named.items():
        m, v = opt_state["m"][k], opt_state["v"][k]
        gf = grads[k].float()
        mf = b1 * m.float() + (1 - b1) * gf
        vf = b2 * v.float() + (1 - b2) * gf * gf
        del gf
        delta = (mf / c1) / (torch.sqrt(vf / c2) + eps) + weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        del delta
        m.copy_(mf)
        v.copy_(vf)
    return params, {"m": opt_state["m"], "v": opt_state["v"], "step": step}
