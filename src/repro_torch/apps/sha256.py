"""SHA-256 in torch integer ops (vectorized over messages).

The paper's Minebench computes real SHA-256 proof-of-work hashes (§6.2);
this is the same compression function, restricted to single-chunk (≤55
byte) messages — a block-header digest + nonce fits.

torch has no uint32 shifts or adds, so the words are carried in int64 and
masked to 32 bits after every add (as ``core/shuffle.py``'s ``_hash_u32``
does); digests come back as uint32, the dtype the reference returns.
"""
from __future__ import annotations

import numpy as np
import torch

_K = np.array([
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2], dtype=np.uint32)

_H0 = np.array([
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19], dtype=np.uint32)

_M32 = 0xFFFFFFFF


def _rotr(x, n):
    """32-bit rotate right of int64-held words in [0, 2^32)."""
    return ((x >> n) | (x << (32 - n))) & _M32


def compress(w16):
    """Compress one padded chunk given as 16 int64-held words (a sequence of
    tensors of one shape, or a (..., 16) int64 tensor). Returns the (..., 8)
    int64-held digest. Each word stays a tensor of its own, so the schedule
    and the 64 rounds are plain elementwise ops (and ``torch.func.vmap``
    batches them)."""
    w = list(w16.unbind(-1)) if isinstance(w16, torch.Tensor) else list(w16)
    for i in range(16, 64):
        a, b = w[i - 15], w[i - 2]
        s0 = _rotr(a, 7) ^ _rotr(a, 18) ^ (a >> 3)
        s1 = _rotr(b, 17) ^ _rotr(b, 19) ^ (b >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & _M32)
    zero = torch.zeros_like(w[0])
    a, b, c, d, e, f, g, h = (zero + int(v) for v in _H0)
    for i in range(64):
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + S1 + ch + int(_K[i]) + w[i]) & _M32
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M32, c, b, a, (t1 + S0 + maj) & _M32
    st = torch.stack([a, b, c, d, e, f, g, h], dim=-1)
    return (st + torch.as_tensor(_H0.astype(np.int64), device=st.device)) & _M32


def sha256_words(w16):
    """Compress one padded 16-word chunk. w16: (..., 16) big-endian words
    (uint32, or int64 holding them). Returns the (..., 8) uint32 digest."""
    return compress(w16.to(torch.int64)).to(torch.uint32)


def sha256_bytes_len(msg_words, nbytes: int):
    """Digest of an ≤55-byte message already packed into (..., 16) words
    (big-endian), with the 0x80 pad bit and bit-length word applied here.
    msg_words must be zero beyond nbytes."""
    w = msg_words.to(torch.int64).clone()
    # set the 0x80 byte at position nbytes
    word_idx = nbytes // 4
    byte_in = nbytes % 4
    w[..., word_idx] += 0x80 << (8 * (3 - byte_in))
    w[..., 15] = nbytes * 8
    return compress(w).to(torch.uint32)


def pack_bytes(data: np.ndarray) -> np.ndarray:
    """(…, 64) uint8 → (…, 16) uint32 big-endian words (host helper)."""
    d = data.astype(np.uint32).reshape(*data.shape[:-1], 16, 4)
    return (d[..., 0] << 24) | (d[..., 1] << 16) | (d[..., 2] << 8) | d[..., 3]
