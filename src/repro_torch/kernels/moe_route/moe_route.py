"""Fused MoE routing (softmax → top-k → renormalise → capacity ordinals) —
CUDA C++ kernel for Hopper.

Replaces the Pallas TPU kernel ``src/repro/kernels/moe_route/moe_route.py::
moe_route_fwd``. The kernel's source, ``src/repro_torch/csrc/moe_route.cu``,
says what bounds it and how it is laid out: one pass over tiles of
``TILE_TOKENS`` tokens, each block taking the per-expert counts of the tiles
before it from a decoupled look-back (``csrc/lookback.cuh``). It is built
with ``nvcc`` at the first launch (``kernels/_cuda.py``) and called through
``ctypes`` on the current stream.

The router runs once per MoE layer of every prefill and decode step, so
the wrapper keeps its host work small: one allocation holds the four
outputs and the look-back's scratch (``outputs``), the device context is
entered only when the tensor is not on the current device, and the stream
handle is read once.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda, count_launch, counted, fake_call, is_fake, require_cuda
from repro_torch.kernels.moe_route.ref import moe_route_ref

#: the most experts the kernel takes (its per-warp counts sit in shared memory)
MAX_EXPERTS = 128
#: the most experts a token takes (each slot's expert and weight sit in registers)
MAX_K = 16
#: tokens per tile, one per thread of a block (``NT`` in the source)
TILE_TOKENS = 256
_fn = None


def _entry():
    global _fn
    if _fn is None:
        _fn = _cuda.entry("moe_route", "moe_route_fwd",
                          [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                          + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])
    return _fn


def scratch_bytes(T: int, E: int) -> int:
    """The look-back's scratch for T tokens and E experts: a tile counter
    and one 64-bit word per (tile, expert); none for a single tile. The
    entry point refuses less than its own count."""
    tiles = -(-T // TILE_TOKENS)
    return 8 + 8 * tiles * E if tiles > 1 else 0


def _scratch_offset(n: int) -> int:
    """Byte offset of the scratch after ``n`` assignments' outputs."""
    return -(-13 * n // 8) * 8


def outputs(T: int, k: int, E: int, device):
    """(w f32, idx i32, pos i32, keep bool), each (T, k) contiguous, and the
    int32 allocation they are views of: the outputs at byte offsets 0, 4Tk,
    8Tk and 12Tk, then the look-back's scratch (``scratch_bytes``) from 13Tk
    rounded up to 8 bytes. Cutting the allocation with ``as_strided``, once
    reinterpreted per other dtype, keeps the tensors made per call few: on
    the decode path they are most of the wrapper's host time."""
    n = T * k
    base = torch.empty((_scratch_offset(n) + scratch_bytes(T, E)) // 4, dtype=torch.int32,
                       device=device)
    shape, strides = (T, k), (k, 1)
    return (base.view(torch.float32).as_strided(shape, strides, 0),
            base.as_strided(shape, strides, n), base.as_strided(shape, strides, 2 * n),
            base.view(torch.bool).as_strided(shape, strides, 12 * n), base)


def _check(logits, k):
    """The launch's preconditions (none reads data)."""
    require_cuda(logits)
    if logits.dtype != torch.float32 or logits.ndim != 2:
        raise ValueError(f"moe_route kernel takes (T, E) float32 logits, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    E = logits.shape[1]
    if not 1 <= k <= MAX_K or not k <= E <= MAX_EXPERTS:
        raise ValueError(f"moe_route kernel takes 1 <= k <= {MAX_K} and k <= E <= "
                         f"{MAX_EXPERTS}, got k {k}, E {E}")


@counted
def moe_route_fwd(logits, k: int, capacity: int):
    """logits: (T, E) float32. Returns (weights f32, idx i32, pos i32, keep
    bool), each (T, k): the top-k experts of each token, lowest index first
    on ties, and each assignment's ordinal within its expert in token-major,
    slot-minor order. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    if is_fake(logits):  # an operation per logit
        if logits.is_cuda:  # priced as the card's call: refused where a launch would be
            _check(logits, k)
        T = logits.shape[0]
        dev = logits.device
        return fake_call((logits,), tuple(torch.empty((T, k), dtype=dt, device=dev) for dt in (
            torch.float32, torch.int32, torch.int32, torch.bool)), logits.numel(), "moe_route")
    if not logits.is_cuda:
        return moe_route_ref(logits, k, capacity)
    _check(logits, k)
    T, E = logits.shape
    w, idx, pos, keep, buf = outputs(T, k, E, logits.device)
    if T == 0:
        return w, idx, pos, keep
    dev, base, n = logits.device.index, buf.data_ptr(), T * k
    off = _scratch_offset(n)
    args = (logits.data_ptr(), base, base + 4 * n, base + 8 * n, base + 12 * n,
            T, E, int(k), int(capacity), base + off, 4 * buf.numel() - off)
    if dev == torch.cuda.current_device():
        err = _entry()(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = _entry()(*args, torch._C._cuda_getCurrentRawStream(dev))
    _cuda.raise_on_error("moe_route", err, "moe_route")
    count_launch(moe_route_fwd, ((T, E), int(k), int(capacity)))
    return w, idx, pos, keep
