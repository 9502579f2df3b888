"""Decode attention over the KV slab — CUDA C++ kernel for Hopper.

Replaces no TPU kernel: the JAX package's decode is the plain masked
attention over the whole cache, kept here as ``ref.decode_attention_ref``.
The kernel's source, ``src/repro_torch/csrc/decode_attention.cu``, says what
bounds it and how it is laid out; it is built with ``nvcc`` at the first
launch (``kernels/_cuda.py``) and called through ``ctypes`` on the tensors'
current stream.

The kernel reads each slot's live rows of the bf16 slab in place, with the
slots' positions read on the device. It has two routes, counted in
``decode_attention_fwd.launches_by_variant``: ``whole`` (one block per
slot and kv head) and ``split`` (each slot's live rows cut into ranges,
one block each, and a merge of their partial softmaxes), chosen by
``splits`` from the number of (slot, kv head) pairs against the card's SMs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _cuda, count_launch, counted, fake_call, is_fake, require_cuda
from repro_torch.kernels.decode_attention.ref import GLOBAL_WINDOW, decode_attention_ref

HEAD_DIMS = (64, 128, 256)
#: query heads a kv head the kernel takes (its template instances)
MAX_GROUP = 8
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the fewest live rows a split is worth: below it a block's loads do not
#: cover their latency
MIN_SPLIT_ROWS = 128
MAX_SPLITS = 32
_fn = None


def splits(B: int, K: int, Smax: int, sms: int) -> int:
    """Blocks each (slot, kv head) pair's rows are cut into: 1 where the
    pairs alone give every SM a block, else enough for about two blocks an
    SM, no split shorter than ``MIN_SPLIT_ROWS`` of the slab."""
    pairs = B * K
    if pairs >= sms:
        return 1
    return max(1, min(-(-2 * sms // pairs), Smax // MIN_SPLIT_ROWS, MAX_SPLITS))


def variant(n_splits: int) -> str:
    return "whole" if n_splits == 1 else "split"


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _entry():
    global _fn
    if _fn is None:
        _fn = _cuda.entry("decode_attention", "decode_attention_fwd",
                          [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                          + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    return _fn


def _check(q, k_cache, v_cache, pos, window, softcap):
    """The launch's preconditions; on fake tensors, all but the alignment,
    which reads their addresses."""
    require_cuda(q, k_cache, v_cache, pos)
    if q.dtype not in _Q_DTYPES or k_cache.dtype != torch.bfloat16 \
            or v_cache.dtype != torch.bfloat16 or pos.dtype != torch.int32:
        raise ValueError(f"decode kernel takes q in float32 or bfloat16, a bfloat16 k/v slab "
                         f"and int32 pos, got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}, "
                         f"{pos.dtype}")
    if q.ndim != 4 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode kernel takes q (B, 1, H, hd), k = v (B, Smax, K, hd), got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, one, H, hd = q.shape
    _, Smax, K, _ = k_cache.shape
    if one != 1 or k_cache.shape[0] != B or k_cache.shape[3] != hd or H % K \
            or pos.shape != (B,) or Smax == 0:
        raise ValueError(f"decode kernel: q {tuple(q.shape)}, k/v {tuple(k_cache.shape)} and "
                         f"pos {tuple(pos.shape)} do not match (one query a slot, H a "
                         f"multiple of K, pos one a slot)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if not 1 <= H // K <= MAX_GROUP:
        raise ValueError(f"decode kernel takes 1 to {MAX_GROUP} query heads a kv head, got "
                         f"{H // K}")
    if window <= 0 or softcap < 0:
        raise ValueError(f"decode kernel: window {window} must be positive, softcap "
                         f"{softcap} non-negative")
    if not is_fake(q) and any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("decode kernel: q and the k/v slab must start on 16-byte "
                         "boundaries, as its 16-byte loads read them")
    if torch.is_grad_enabled() and q.requires_grad:
        raise NotImplementedError("decode_attention_fwd records no graph: run it under "
                                  "torch.no_grad()")


@counted
def decode_attention_fwd(q, k_cache, v_cache, pos, *, window=GLOBAL_WINDOW, softcap=0.0):
    """q: (B, 1, H, hd); k_cache, v_cache: (B, Smax, K, hd), H = K·G; pos:
    (B,) int32, the row each slot's query sits at (its live rows are 0 ..
    min(pos, Smax - 1), fewer than ``window`` back). Returns (B, 1, H, hd)
    in v's dtype. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    window = min(int(window), GLOBAL_WINDOW)
    softcap = float(softcap or 0.0)
    out_dtype = v_cache.dtype
    if is_fake(q):
        if q.is_cuda:  # priced as the card's call: refused where a launch would be
            _check(q.contiguous(), k_cache, v_cache, pos, window, softcap)
        # the positions are data: priced as every slot at the slab's end
        B, _, H, hd = q.shape
        flops = 4 * hd * B * H * min(k_cache.shape[1], window)
        o = q.new_empty(q.shape, dtype=out_dtype)
        return fake_call((q, k_cache, v_cache, pos), (o,), flops, "decode_attention")[0]
    if not q.is_cuda:
        return decode_attention_ref(q, k_cache, v_cache, pos, window=window, softcap=softcap)
    q = q.contiguous()
    _check(q, k_cache, v_cache, pos, window, softcap)
    B, _, H, hd = q.shape
    _, Smax, K, _ = k_cache.shape
    n = splits(B, K, Smax, _sms(q.device.index if q.device.index is not None else
                                torch.cuda.current_device()))
    o = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    part_ml = part_o = None
    if n > 1:
        part_ml = torch.empty((B, H, n, 2), dtype=torch.float32, device=q.device)
        part_o = torch.empty((B, H, n, hd), dtype=torch.float32, device=q.device)
    fn = _entry()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
                 o.data_ptr(), part_ml.data_ptr() if n > 1 else None,
                 part_o.data_ptr() if n > 1 else None, _Q_DTYPES[q.dtype], B, K, H // K,
                 Smax, hd, window, softcap, hd**-0.5, n,
                 torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.raise_on_error("decode_attention", err, "decode attention")
    count_launch(decode_attention_fwd, (tuple(q.shape), tuple(k_cache.shape), str(q.dtype),
                                        window, softcap, n), variant(n))
    return o
