"""Fused MoE routing (softmax → top-k → renormalise → capacity ordinals) —
CUDA C++ kernel for Hopper.

Replaces the Pallas TPU kernel ``src/repro/kernels/moe_route/moe_route.py::
moe_route_fwd``. The kernel's source, ``src/repro_torch/csrc/moe_route.cu``,
says what bounds it and how it is laid out; it is built with ``nvcc`` at the
first launch (``kernels/_cuda.py``) and called through ``ctypes`` on the
tensor's current stream.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda, count_launch, counted, require_cuda
from repro_torch.kernels.moe_route.ref import moe_route_ref

#: the most experts the kernel takes (its per-expert counts sit in shared memory)
MAX_EXPERTS = 64
_fn = None


def _entry():
    global _fn
    if _fn is None:
        _fn = _cuda.entry("moe_route", "moe_route_fwd",
                          [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return _fn


@counted
def moe_route_fwd(logits, k: int, capacity: int):
    """logits: (T, E) float32. Returns (weights f32, idx i32, pos i32, keep
    bool), each (T, k): the top-k experts of each token, lowest index first
    on ties, and each assignment's ordinal within its expert in token-major,
    slot-minor order. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    if not logits.is_cuda:
        return moe_route_ref(logits, k, capacity)
    require_cuda(logits)
    if logits.dtype != torch.float32 or logits.ndim != 2:
        raise ValueError(f"moe_route kernel takes (T, E) float32 logits, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    T, E = logits.shape
    if k not in (1, 2) or not k <= E <= MAX_EXPERTS:
        raise ValueError(f"moe_route kernel takes k in (1, 2) and k <= E <= {MAX_EXPERTS}, "
                         f"got k {k}, E {E}")
    dev = logits.device
    w = torch.empty((T, k), dtype=torch.float32, device=dev)
    idx = torch.empty((T, k), dtype=torch.int32, device=dev)
    pos = torch.empty((T, k), dtype=torch.int32, device=dev)
    keep = torch.empty((T, k), dtype=torch.bool, device=dev)
    fn = _entry()
    with torch.cuda.device(dev):
        err = fn(logits.data_ptr(), w.data_ptr(), idx.data_ptr(), pos.data_ptr(),
                 keep.data_ptr(), T, E, int(k), int(capacity),
                 torch.cuda.current_stream(dev).cuda_stream)
    _cuda.raise_on_error("moe_route", err, "moe_route")
    count_launch(moe_route_fwd, ((T, E), int(k), int(capacity)))
    return w, idx, pos, keep
