"""Public SSD scan and prefix-scan wrappers.

``ssd_scan`` is the Mamba-2 SSD chunk scan (the mixer's prefill); it pads S
to a whole number of chunks with dt = 0 (decay 1, input 0: a state no-op),
as ``ssd_chunked`` does. ``prefix_scan`` is the shuffle engine's prefix pass
(the reference hosts it beside the SSD scan because its Pallas kernel reuses
the SSD carry pattern). The tensors' device picks kernel or plain version.

``ssd_scan`` is differentiable as the JAX wrapper is (a ``custom_vjp``):
its ``torch.autograd.Function`` runs ``ssd_scan_fwd`` forward (the kernel
on the card), which records no graph, and its backward is the vjp of
``ssd_ref`` over ``(x, dt, A_log, Bm, Cm)`` from the saved inputs, for both
outputs. The padding, the f32 casts of ``dt``/``A_log`` and the contiguous
copies stay outside the Function, so the gradient flows through them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.prefix import prefix_scan_fwd
from repro_torch.kernels.ssd_scan.ref import ssd_ref
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_fwd


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A_log, Bm, Cm, chunk):
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A_log, Bm, Cm)
        return ssd_scan_fwd(x, dt, A_log, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, gy, gstate):
        inputs = tuple(t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            y, state = ssd_ref(*inputs, ctx.chunk)
        outs = [(o, g) for o, g in ((y, gy), (state, gstate)) if g is not None]
        grads = torch.autograd.grad([o for o, _ in outs], inputs, [g for _, g in outs],
                                    allow_unused=True)
        return (*grads, None)


def ssd_scan(x, dt, A_log, Bm, Cm, chunk):
    """x: (B, S, H, P); dt: (B, S, H); A_log: (H,); Bm/Cm: (B, S, G, N).
    Returns (y (B, S, H, P), final state (B, H, P, N) f32)."""
    S = x.shape[1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    if x.is_cuda:
        x, Bm, Cm = x.contiguous(), Bm.contiguous(), Cm.contiguous()
        dt, A_log = dt.float().contiguous(), A_log.float().contiguous()
    y, state = _SSD.apply(x, dt, A_log, Bm, Cm, chunk)
    return y[:, :S], state


def prefix_scan(x: torch.Tensor, op: str = "sum", block: int = 512,
                reverse: bool = False) -> torch.Tensor:
    """Inclusive prefix scan (sum/max/min) over a 1-D tensor.

    ``reverse=True`` scans from the tail (the suffix-min pass of
    ``segment_totals``). Bool rides as i32 and is cast back. Bit-identical
    to ``prefix_scan_ref`` for integer dtypes and for float max/min. The
    tensor's device picks kernel or plain version; the kernel scans from
    the tail and masks its ragged tail itself, so nothing is flipped or
    padded."""
    (N,) = x.shape
    if N == 0:
        return x
    squeeze_bool = x.dtype == torch.bool
    v = x.to(torch.int32) if squeeze_bool else x
    out = prefix_scan_fwd(v.contiguous(), op=op, block=block, reverse=reverse)
    return out.to(torch.bool) if squeeze_bool else out
