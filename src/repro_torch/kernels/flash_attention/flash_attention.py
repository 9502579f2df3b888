"""Blockwise fused attention forward (flash) — CUDA C++ kernel for Hopper.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention/
flash_attention.py::flash_attention_fwd``. The kernel's source,
``src/repro_torch/csrc/flash_attention.cu``, says what bounds it and how it
is laid out; it is built with ``nvcc`` at the first launch
(``kernels/_cuda.py``) and called through ``ctypes`` on the tensors'
current stream.

The kernel has two routes. ``variant`` picks one by dtype and head dim
before the launch and the wrapper passes it to the C entry point, which
only dispatches: ``wgmma`` (bf16 at hd 64 and 128, both products on the
tensor cores with TMA-fed tiles) and ``fma`` (f32 at every hd, and bf16 at
hd 256: f32 FMAs on the CUDA cores). Each launch is counted under its route
in ``flash_attention_fwd.launches_by_variant``. Neither route falls back to
the other: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda, count_launch, counted, fake_call, is_fake, require_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {"fma": 0, "wgmma": 1}
#: head dims the bf16 tensor-core route takes (at hd 256 its O accumulator
#: would not fit beside S and P in a warpgroup's registers)
WGMMA_HEAD_DIMS = (64, 128)
_fn = None


def variant(dtype, hd: int) -> str:
    """The route a CUDA call of this dtype and head dim takes: ``wgmma``
    for bf16 at hd 64 or 128, else ``fma`` (f32 inputs hold a tolerance
    that bf16 or TF32 products cannot)."""
    return "wgmma" if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS else "fma"


def live_pairs(Sq: int, kv_len: int, causal: bool, window, q_offset: int) -> int:
    """The (row, key) pairs a call attends over: row i sits at position
    i + q_offset and sees the keys below kv_len, at or before it where
    causal, and fewer than ``window`` positions back where windowed."""
    pairs = 0
    for pos in range(q_offset, q_offset + Sq):
        hi = min(pos, kv_len - 1) if causal else kv_len - 1
        lo = max(0, pos - window + 1) if window else 0
        pairs += max(0, hi - lo + 1)
    return pairs


def _entry():
    global _fn
    if _fn is None:
        _fn = _cuda.entry("flash_attention", "flash_attention_fwd",
                          [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
                          + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    return _fn


def _check(q, k, v, q_offset, kv_len, window, softcap):
    """The launch's preconditions; on fake tensors, all but the alignment,
    which reads their addresses."""
    require_cuda(q, k, v)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash kernel takes float32 or bfloat16 q, k, v of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash kernel takes q (B, H, Sq, hd), k = v (B, K, Skv, "
                         f"hd), got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[1]:
        raise ValueError(f"flash kernel: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (H must be a multiple of K)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if q_offset < 0 or not 0 <= kv_len <= k.shape[2]:
        raise ValueError(f"flash kernel: q_offset {q_offset} must be >= 0 and kv_len "
                         f"{kv_len} within [0, {k.shape[2]}]")
    if window is not None and window <= 0 or softcap < 0:
        raise ValueError(f"flash kernel: window {window} must be positive, softcap "
                         f"{softcap} non-negative")
    if (variant(q.dtype, hd) == "wgmma" and not is_fake(q)
            and any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError("flash kernel (wgmma route): q, k, v must start on 16-byte "
                         "boundaries, as TMA reads them")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "flash_attention_fwd records no graph: call ops.flash_attention (the "
            "differentiable entry, whose backward is attention_ref's) or run under "
            "torch.no_grad()")


@counted
def flash_attention_fwd(q, k, v, *, causal=True, window=None, softcap=0.0,
                        q_offset=0, kv_len=None):
    """q: (B, H, Sq, hd); k, v: (B, K, Skv, hd), H = K·G. ``kv_len`` masks
    key columns at and beyond it (default Skv). Returns (B, H, Sq, hd) in
    q's dtype. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises."""
    Skv = k.shape[2]
    kv_len = Skv if kv_len is None else int(kv_len)
    if is_fake(q):
        if q.is_cuda:  # priced as the card's call: refused where a launch would be
            _check(q, k, v, q_offset, kv_len, window, softcap)
        B, H, Sq, hd = q.shape
        flops = 4 * hd * B * H * live_pairs(Sq, kv_len, causal, window, q_offset)
        return fake_call((q, k, v), (torch.empty_like(q),), flops, "flash_attention")[0]
    if not q.is_cuda:
        return attention_ref(q, k[:, :, :kv_len], v[:, :, :kv_len], causal=causal,
                             window=window, softcap=softcap, q_offset=q_offset)
    _check(q, k, v, q_offset, kv_len, window, softcap)
    B, H, Sq, hd = q.shape
    route = variant(q.dtype, hd)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    fn = _entry()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _DTYPES[q.dtype],
                 _ROUTES[route], B, H, H // k.shape[1], Sq, Skv, hd, int(q_offset), kv_len,
                 int(bool(causal)), -1 if window is None else int(window), float(softcap or 0.0), hd**-0.5,
                 torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.raise_on_error("flash_attention", err, "flash attention")
    count_launch(flash_attention_fwd, (tuple(q.shape), tuple(k.shape), str(q.dtype),
                                       bool(causal), window, float(softcap), int(q_offset)),
                 route)
    return o
