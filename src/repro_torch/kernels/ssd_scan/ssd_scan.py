"""Mamba-2 SSD chunk scan — CUDA C++ kernel for Hopper.

Replaces the Pallas TPU kernel ``src/repro/kernels/ssd_scan/ssd_scan.py::
ssd_scan_fwd``. The kernel's source, ``src/repro_torch/csrc/ssd_scan.cu``,
says what bounds it and how it is laid out; it is built with ``nvcc`` at the
first launch (``kernels/_cuda.py``) and called through ``ctypes`` on the
tensors' current stream. One call is four launches (C·Bᵀ, the chunks' own
states, the pass across chunks, the chunk scan), counted as one launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda, count_launch, counted, fake_call, is_fake, require_cuda
from repro_torch.kernels.ssd_scan.ref import ssd_ref

#: the largest chunk the kernel takes (a block scans the chunk's decays, two
#: steps a thread)
MAX_CHUNK = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _entry():
    global _fn
    if _fn is None:
        _fn = _cuda.entry("ssd_scan", "ssd_scan_fwd",
                          [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    return _fn


def _check(x, dt, A_log, Bm, Cm, chunk):
    require_cuda(x, dt, A_log, Bm, Cm)
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"ssd_scan kernel takes float32 or bfloat16 x, Bm, Cm of one "
                         f"dtype, got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A_log.dtype != torch.float32:
        raise ValueError(f"ssd_scan kernel takes float32 dt and A_log, got {dt.dtype}, "
                         f"{A_log.dtype}")
    if x.ndim != 4 or Bm.ndim != 4 or Bm.shape != Cm.shape:
        raise ValueError(f"ssd_scan kernel takes x (B, S, H, P), Bm = Cm (B, S, G, N), "
                         f"got {tuple(x.shape)}, {tuple(Bm.shape)}, {tuple(Cm.shape)}")
    B, S, H, _ = x.shape
    if (tuple(dt.shape) != (B, S, H) or tuple(A_log.shape) != (H,)
            or tuple(Bm.shape[:2]) != (B, S) or H % Bm.shape[2]):
        raise ValueError(f"ssd_scan kernel: dt {tuple(dt.shape)}, A_log "
                         f"{tuple(A_log.shape)}, Bm {tuple(Bm.shape)} do not fit x "
                         f"{tuple(x.shape)} (H must be a multiple of G)")
    if not 0 < chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"ssd_scan kernel takes 0 < chunk <= {MAX_CHUNK} dividing S, got "
                         f"chunk {chunk}, S {S} (ops.ssd_scan pads S)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A_log, Bm, Cm)):
        raise NotImplementedError(
            "ssd_scan_fwd records no graph: call ops.ssd_scan (the differentiable "
            "entry, whose backward is ssd_ref's) or run under torch.no_grad()")


def work_flops(x_shape, bn_shape, chunk) -> int:
    """Operations of a call: C·Bᵀ over the causal pairs of each (batch,
    chunk, group), the scores times x·Δ over the same pairs, C against the
    carried state and the state update, per head."""
    B, S, H, P = x_shape
    G, N = bn_shape[2], bn_shape[3]
    nc, pairs = S // chunk, chunk * (chunk + 1) // 2
    return 2 * B * nc * (G * pairs * N + H * (pairs * P + 2 * chunk * N * P))


def workspace_floats(B, S, H, P, G, N, chunk) -> int:
    """Floats of the kernel's scratch: C·Bᵀ of every (batch, chunk, group);
    per (batch, chunk, head) its own state (then its incoming one), its
    total decay, and its cumulative decays and steps."""
    return B * (S // chunk) * (G * chunk * chunk + H * P * N + H + 2 * H * chunk)


@counted
def ssd_scan_fwd(x, dt, A_log, Bm, Cm, chunk):
    """x: (B, S, H, P); dt: (B, S, H) f32; A_log: (H,) f32; Bm/Cm: (B, S, G,
    N); S % chunk == 0. Returns (y (B, S, H, P) in x's dtype, final state
    (B, H, P, N) f32). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    if is_fake(x):
        if x.is_cuda:  # priced as the card's call: refused where a launch would be
            _check(x, dt, A_log, Bm, Cm, chunk)
        B, S, H, P = x.shape
        state = torch.empty((B, H, P, Bm.shape[3]), dtype=torch.float32, device=x.device)
        return fake_call((x, dt, A_log, Bm, Cm), (torch.empty_like(x), state),
                         work_flops(x.shape, Bm.shape, chunk), "ssd_scan")
    if not x.is_cuda:
        return ssd_ref(x, dt, A_log, Bm, Cm, chunk)
    _check(x, dt, A_log, Bm, Cm, chunk)
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    work = torch.empty(workspace_floats(B, S, H, P, G, N, chunk), dtype=torch.float32,
                       device=x.device)
    fn = _entry()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), y.data_ptr(), state.data_ptr(), work.data_ptr(),
                 _DTYPES[x.dtype], B, S, H, P, G, N, int(chunk),
                 torch.cuda.current_stream(x.device).cuda_stream)
    _cuda.raise_on_error("ssd_scan", err, "ssd_scan")
    count_launch(ssd_scan_fwd, (tuple(x.shape), tuple(Bm.shape), str(x.dtype), int(chunk)))
    return y, state
