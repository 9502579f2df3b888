"""Public wrapper of the flash attention kernel, with the JAX wrapper's
signature (``src/repro/kernels/flash_attention/ops.py``).

The tensors' device picks the path: a CPU tensor takes the plain version
(the counterpart of Pallas's interpret mode), a CUDA tensor launches the
kernel or raises — it never falls back. The JAX wrapper pads Sq and Skv to
block multiples; the CUDA kernel masks its own ragged edge, so nothing is
padded here, and ``block_q``/``block_k`` are kept for the signature only
(the kernel's tile sizes are its own). There is no backward yet: a CUDA
call whose inputs require grad raises (ROADMAP: the training path).
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention.flash_attention import flash_attention_fwd


def flash_attention(q, k, v, causal=True, window=None, softcap=0.0, q_offset=0,
                    block_q=128, block_k=128):
    """q: (B, H, Sq, hd); k, v: (B, K, Skv, hd), H = K·G → (B, H, Sq, hd)."""
    del block_q, block_k
    if q.is_cuda:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               softcap=softcap, q_offset=q_offset)
