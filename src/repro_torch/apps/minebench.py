"""Minebench (paper §6.2, Figs. 13–14): SHA-256 proof-of-work.

Two chained maps exactly as in the paper: map₁ (data-intensive) reduces a
block's transactions to a Merkle-style root; map₂ (compute-intensive)
iterates nonces over the real SHA-256 compression until the difficulty
condition is met (bounded iterations for benchmark determinism).

The multi-"language" variant runs map₁ on one worker and map₂ on another
with importData in between (paper Fig. 14) — in spark mode that hop
serializes through the host (the pipe cost the paper measures).

The row functions run under ``torch.func.vmap`` (``core/executor.py``), so
they take no data-dependent branch and no ``.item()``. ``mine`` hashes all
``iters`` nonces as one batch and keeps the lowest nonce that hits: the
same ``(nonce, found)`` as a loop that stops at the first hit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.apps.sha256 import compress
from repro_torch.core.native import ignis_export


def make_blocks(n_blocks: int, txs_per_block: int = 16, seed: int = 0) -> np.ndarray:
    """Synthetic transaction sets: (n_blocks, txs_per_block, 16) uint32."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (n_blocks, txs_per_block, 16), dtype=np.uint32)


def merkle_root(txs):
    """map₁: pairwise SHA-256 reduction of the tx digests → (…, 8) root."""
    h = compress(txs.to(torch.int64))  # (T, 8) digests
    while h.shape[-2] > 1:
        if h.shape[-2] % 2:
            h = torch.cat([h, h[..., -1:, :]], dim=-2)
        pair = torch.cat([h[..., 0::2, :], h[..., 1::2, :]], dim=-1)  # (T/2, 16)
        h = compress(pair)
    return h[..., 0, :].to(torch.uint32)


def mine(root, iters: int = 64, difficulty_bits: int = 12):
    """map₂: hash nonces 0 … iters-1; return (first nonce under the target,
    found). root: (…, 8) words; the header is root, nonce, zeros and the
    bit length 36·8 in its last word, as in the reference."""
    target = 1 << (32 - difficulty_bits)
    root = root.to(torch.int64)
    lead = root.shape[:-1]
    nonce = torch.arange(iters, dtype=torch.int64, device=root.device)
    zero = torch.zeros((*lead, iters), dtype=torch.int64, device=root.device)
    words = ([zero + root[..., j, None] for j in range(8)] + [zero + nonce]
             + [zero] * 6 + [zero + 36 * 8])
    hit = compress(words)[..., 0] < target  # (…, iters)
    first = torch.where(hit, nonce, iters).amin(dim=-1)
    found = hit.any(dim=-1)
    best = torch.where(found, first, 0)
    return best.to(torch.uint32), found


def map1_fn(txs):
    return merkle_root(txs)


def make_map2_fn(iters: int = 64, difficulty_bits: int = 12):
    def f(root):
        nonce, found = mine(root, iters, difficulty_bits)
        return {"nonce": nonce, "found": found}

    return f


@ignis_export("minebench_mpi")
def minebench_native(ctx, data=None, valid=None):
    """Native SPMD variant: whole pipeline in one on-device program, every
    block at once."""
    iters = int(ctx.var("iters", 64))
    bits = int(ctx.var("difficulty_bits", 12))
    roots = merkle_root(data)
    nonce, found = mine(roots, iters, bits)
    return {"nonce": nonce, "found": found}, valid
