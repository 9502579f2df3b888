"""Plain torch version of the decode attention kernel: the masked ``attend``
over the whole cache, as the JAX package's decode computes it
(``src/repro/models/attention.py::decode_attention``).

Layout: q (B, 1, H, hd); k_cache, v_cache (B, Smax, K, hd) with H = K·G;
pos (B,) int32. Row j of slot b is live where j <= pos[b] and
pos[b] - j < window; every other row is masked by the position trick
(its ``pos_kv`` is -1).
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import GLOBAL_WINDOW, attend


def decode_attention_ref(q, k_cache, v_cache, pos, *, window=GLOBAL_WINDOW, softcap=0.0):
    """(B, 1, H, hd) in v's dtype: scores in f32 from the exact inputs,
    probabilities rounded to v's dtype before P·V (``attend``)."""
    Smax = k_cache.shape[1]
    idx = torch.arange(Smax, device=q.device, dtype=torch.int32)[None, :]  # (1, Smax)
    pos_kv = torch.where(idx <= pos[:, None], idx, -1)  # unwritten slots invalid
    return attend(q, k_cache, v_cache, pos[:, None], pos_kv, window=window, causal=True,
                  cap=softcap, chunk=0)
