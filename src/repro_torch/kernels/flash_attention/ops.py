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
card), which records no graph. ``variant`` picks the backward before
anything runs: a CUDA call on the ``wgmma`` route (bf16 at hd 64 and 128)
saves ``(q, k, v, o, lse)``, its forward writing each row's log-sum-exp,
and its backward is the kernel ``flash_attention_bwd``; every other call
(the CPU, the ``fma`` route) saves ``(q, k, v)`` and its backward
recomputes through ``attention_ref`` and returns its vjp, as the JAX
package's does. The inputs are made contiguous before the Function (the
kernel reads them so), so the gradient flows back through the caller's
transposes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    attention_vjp, flash_attention_bwd, flash_attention_fwd, variant)


def kernel_backward(q) -> bool:
    """Whether the Function's backward at ``q`` is the kernel: a CUDA
    tensor on the ``wgmma`` route."""
    return q.is_cuda and variant(q.dtype, q.shape[-1]) == "wgmma"


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset):
        ctx.statics = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
        if kernel_backward(q) and any(ctx.needs_input_grad[:3]):
            o, lse = flash_attention_fwd(q, k, v, with_lse=True, **ctx.statics)
            ctx.save_for_backward(q, k, v, o, lse)
            return o
        ctx.save_for_backward(q, k, v)
        return flash_attention_fwd(q, k, v, **ctx.statics)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors  # once: a checkpoint's recompute unpacks them once
        if kernel_backward(saved[0]):
            dq, dk, dv = flash_attention_bwd(*saved, g.contiguous(), **ctx.statics)
        else:
            dq, dk, dv = attention_vjp(*saved, g, **ctx.statics)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal=True, window=None, softcap=0.0, q_offset=0,
                    block_q=128, block_k=128):
    """q: (B, H, Sq, hd); k, v: (B, K, Skv, hd), H = K·G → (B, H, Sq, hd)."""
    del block_q, block_k
    if q.is_cuda:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _Flash.apply(q, k, v, causal, window, softcap, q_offset)
