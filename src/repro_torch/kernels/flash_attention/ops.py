"""Public wrapper of the flash attention kernel, with the JAX wrapper's
signature (``src/repro/kernels/flash_attention/ops.py``), differentiable.

The tensors' device picks the path: a CPU tensor takes the plain version
(the counterpart of Pallas's interpret mode), a CUDA tensor launches the
kernel or raises — it never falls back. The JAX wrapper pads Sq and Skv to
block multiples; the CUDA kernel masks its own ragged edge, so nothing is
padded here, and ``block_q``/``block_k`` are kept for the signature only
(the kernel's tile sizes are its own).

``flash_attention`` is a ``torch.autograd.Function`` as the JAX wrapper is
a ``custom_vjp``: the forward is ``flash_attention_fwd`` (the kernel on the
card), which records no graph, and the backward recomputes through
``attention_ref`` and returns its vjp, from the saved ``(q, k, v)``. The
JAX package has no backward kernel either. The inputs are made contiguous
before the Function (the kernel reads them so), so the gradient flows back
through the caller's transposes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import attention_ref


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset):
        ctx.statics = (causal, window, softcap, q_offset)
        ctx.save_for_backward(q, k, v)
        return flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset)

    @staticmethod
    def backward(ctx, g):
        causal, window, softcap, q_offset = ctx.statics
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            o = attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                              q_offset=q_offset)
        dq, dk, dv = torch.autograd.grad(o, (q, k, v), g)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal=True, window=None, softcap=0.0, q_offset=0,
                    block_q=128, block_k=128):
    """q: (B, H, Sq, hd); k, v: (B, K, Skv, hd), H = K·G → (B, H, Sq, hd)."""
    del block_q, block_k
    if q.is_cuda:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _Flash.apply(q, k, v, causal, window, softcap, q_offset)
