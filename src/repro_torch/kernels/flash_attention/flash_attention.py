"""Blockwise fused attention (flash) — CUDA C++ kernels for Hopper: the
forward, and the backward of its ``wgmma`` route.

The forward replaces the Pallas TPU kernel ``src/repro/kernels/
flash_attention/flash_attention.py::flash_attention_fwd``; the backward
(``flash_attention_bwd``) replaces none: the JAX package differentiates its
plain version. The kernels' source, ``src/repro_torch/csrc/
flash_attention.cu``, says what bounds them and how they are laid out; it
is built with ``nvcc`` at the first launch (``kernels/_cuda.py``) and
called through ``ctypes`` on the tensors' current stream.

The kernel has two routes. ``variant`` picks one by dtype and head dim
before the launch and the wrapper passes it to the C entry point, which
only dispatches: ``wgmma`` (bf16 at hd 64 and 128, both products on the
tensor cores with TMA-fed tiles) and ``fma`` (f32 at every hd, and bf16 at
hd 256: f32 FMAs on the CUDA cores). Each launch is counted under its route
in ``flash_attention_fwd.launches_by_variant``. Neither route falls back to
the other: a failed build or launch raises.

On the ``wgmma`` route the forward can also return each row's log-sum-exp
(``with_lse``), which ``flash_attention_bwd`` takes with the saved q, k, v
and o to compute dq, dk and dv without the score matrix ever reaching
device memory (counted under ``wgmma`` in its own ``launches_by_variant``).
The ``fma`` route has no backward kernel: its Function differentiates
``attention_ref``.
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
#: the log-sum-exp's rows are padded to a multiple of this (the backward's
#: tiles of 64 or 128 query rows read whole rows of it)
LSE_PAD = 128
_fn = None
_bwd = None


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


def lse_rows(Sq: int) -> int:
    """The padded row count of a call's log-sum-exp: (B, H, lse_rows(Sq))."""
    return -(-Sq // LSE_PAD) * LSE_PAD


def attention_vjp(q, k, v, g, **kw):
    """(dq, dk, dv): ``attention_ref``'s vjp at (q, k, v) for the upstream
    gradient ``g`` (the plain backward)."""
    xs = [t.detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        o = attention_ref(*xs, **kw)
    return torch.autograd.grad(o, xs, g)


def _entry():
    global _fn
    if _fn is None:
        _fn = _cuda.entry("flash_attention", "flash_attention_fwd",
                          [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13
                          + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    return _fn


def _bwd_entry():
    global _bwd
    if _bwd is None:
        _bwd = _cuda.entry("flash_attention", "flash_attention_bwd",
                           [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
                           + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    return _bwd


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
            "differentiable entry, whose backward is flash_attention_bwd or "
            "attention_ref's) or run under torch.no_grad()")


@counted
def flash_attention_fwd(q, k, v, *, causal=True, window=None, softcap=0.0,
                        q_offset=0, kv_len=None, with_lse=False):
    """q: (B, H, Sq, hd); k, v: (B, K, Skv, hd), H = K·G. ``kv_len`` masks
    key columns at and beyond it (default Skv). Returns (B, H, Sq, hd) in
    q's dtype, and with ``with_lse`` (a CUDA call on the ``wgmma`` route)
    also each row's log-sum-exp, f32 (B, H, ``lse_rows(Sq)``), rows past Sq
    unwritten. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises."""
    Skv = k.shape[2]
    kv_len = Skv if kv_len is None else int(kv_len)
    B, H, Sq, hd = q.shape
    if with_lse and (not q.is_cuda or variant(q.dtype, hd) != "wgmma"):
        raise ValueError("flash kernel: the log-sum-exp is written only by a CUDA call "
                         f"on the wgmma route (bf16 at hd {WGMMA_HEAD_DIMS}), got "
                         f"{q.dtype} at hd {hd} on {q.device}")
    lse = (torch.empty((B, H, lse_rows(Sq)), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if is_fake(q):
        if q.is_cuda:  # priced as the card's call: refused where a launch would be
            _check(q, k, v, q_offset, kv_len, window, softcap)
        flops = 4 * hd * B * H * live_pairs(Sq, kv_len, causal, window, q_offset)
        outs = fake_call((q, k, v), (torch.empty_like(q),) + ((lse,) if with_lse else ()),
                         flops, "flash_attention")
        return tuple(outs) if with_lse else outs[0]
    if not q.is_cuda:
        return attention_ref(q, k[:, :, :kv_len], v[:, :, :kv_len], causal=causal,
                             window=window, softcap=softcap, q_offset=q_offset)
    _check(q, k, v, q_offset, kv_len, window, softcap)
    route = variant(q.dtype, hd)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return (o, lse) if with_lse else o
    fn = _entry()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr() if with_lse else None, lse.shape[2] if with_lse else 0,
                 _DTYPES[q.dtype], _ROUTES[route], B, H, H // k.shape[1], Sq, Skv, hd,
                 int(q_offset), kv_len, int(bool(causal)), -1 if window is None else int(window),
                 float(softcap or 0.0), hd**-0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.raise_on_error("flash_attention", err, "flash attention")
    count_launch(flash_attention_fwd, (tuple(q.shape), tuple(k.shape), str(q.dtype),
                                       bool(causal), window, float(softcap), int(q_offset)),
                 route)
    return (o, lse) if with_lse else o


def _check_bwd(q, k, v, o, lse, do, q_offset, window, softcap):
    """The backward launch's preconditions; on fake tensors, all but the
    alignment, which reads their addresses."""
    require_cuda(q, k, v, o, lse, do)
    if any(t.dtype != torch.bfloat16 for t in (q, k, v, o, do)) or lse.dtype != torch.float32:
        raise ValueError(f"flash backward kernel takes bfloat16 q, k, v, o, dO and a float32 "
                         f"log-sum-exp, got {[str(t.dtype) for t in (q, k, v, o, do, lse)]}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or o.shape != q.shape \
            or do.shape != q.shape:
        raise ValueError(f"flash backward kernel takes q = o = dO (B, H, Sq, hd), k = v (B, K, "
                         f"Skv, hd), got {[tuple(t.shape) for t in (q, k, v, o, do)]}")
    B, H, Sq, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[1]:
        raise ValueError(f"flash backward kernel: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (H must be a multiple of K: G = H / K)")
    if hd not in WGMMA_HEAD_DIMS:
        raise ValueError(f"flash backward kernel takes head_dim in {WGMMA_HEAD_DIMS}, got {hd}")
    if lse.shape != (B, H, lse_rows(Sq)):
        raise ValueError(f"flash backward kernel: log-sum-exp {tuple(lse.shape)}, expected "
                         f"{(B, H, lse_rows(Sq))} (the forward's with_lse)")
    if q_offset < 0 or window is not None and window <= 0 or softcap < 0:
        raise ValueError(f"flash backward kernel: q_offset {q_offset} must be >= 0, window "
                         f"{window} positive, softcap {softcap} non-negative")
    if not is_fake(q) and any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
        raise ValueError("flash backward kernel: q, k, v, o and dO must start on 16-byte "
                         "boundaries, as TMA and the vector loads read them")


@counted
def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=None, softcap=0.0,
                        q_offset=0):
    """The gradients (dq, dk, dv) of ``flash_attention_fwd`` at (q, k, v)
    for the upstream gradient ``do``, from its output ``o`` and log-sum-exp
    ``lse`` (``with_lse``). A CPU tensor takes the plain version
    (``attention_ref``'s vjp; ``o`` and ``lse`` unread); a CUDA tensor on
    the ``wgmma`` route launches the kernels or raises."""
    if is_fake(q):
        if q.is_cuda:  # priced as the card's call: refused where a launch would be
            _check_bwd(q, k, v, o, lse, do, q_offset, window, softcap)
        B, H, Sq, hd = q.shape
        flops = 10 * hd * B * H * live_pairs(Sq, k.shape[2], causal, window, q_offset)
        return tuple(fake_call((q, k, v, o, lse, do), (torch.empty_like(q), torch.empty_like(k),
                                                       torch.empty_like(v)),
                               flops, "flash_attention_bwd"))
    if not q.is_cuda:
        return attention_vjp(q, k, v, do, causal=causal, window=window, softcap=softcap,
                             q_offset=q_offset)
    _check_bwd(q, k, v, o, lse, do, q_offset, window, softcap)
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    rows = lse.shape[2]
    dd = torch.empty((B, H, rows), dtype=torch.float32, device=q.device)
    dqacc = torch.empty((B * H * rows * hd,), dtype=torch.float32, device=q.device)
    fn = _bwd_entry()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 do.data_ptr(), dd.data_ptr(), dqacc.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), B, H, H // K, Sq, Skv, rows, hd, int(q_offset),
                 int(bool(causal)), -1 if window is None else int(window),
                 float(softcap or 0.0), hd**-0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.raise_on_error("flash_attention", err, "flash attention backward")
    count_launch(flash_attention_bwd, (tuple(q.shape), tuple(k.shape), str(q.dtype),
                                       bool(causal), window, float(softcap), int(q_offset)),
                 "wgmma")
    return dq, dk, dv
