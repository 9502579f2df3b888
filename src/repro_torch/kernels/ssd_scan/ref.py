"""Plain torch versions of the SSD scan kernel (= the model-side chunked
SSD) and of the prefix-scan kernel (= torch's cumulative ops), and mirrors
of the kernels' dataflows: ``ssd_stages_ref`` (the SSD kernel's four
steps) and ``prefix_scan_lookback`` (the prefix scan's one pass)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.mamba2 import ssd_chunked


def ssd_ref(x, dt, A_log, Bm, Cm, chunk):
    """x: (b, s, h, p); dt: (b, s, h) (softplus applied); A_log: (h,);
    Bm/Cm: (b, s, g, n). Returns (y, final_state)."""
    return ssd_chunked(x, dt, A_log, Bm, Cm, chunk)


def _split(v):
    """v as the kernel's tensor cores see an f32 operand: hi = bf16(v) and
    lo = bf16(v - hi), both back in f32 (lo is 0 where v is a bf16 value)."""
    hi = v.bfloat16().float()
    return hi, (v - hi).bfloat16().float()


def _product(eq, a, b, split):
    """einsum ``eq`` of two f32 operands; with ``split``, as the kernel
    forms it: hi·hi + hi·lo + lo·hi of the operands' bf16 pairs."""
    if not split:
        return torch.einsum(eq, a, b)
    (ah, al), (bh, bl) = _split(a), _split(b)
    return torch.einsum(eq, ah, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)


def ssd_stages_ref(x, dt, A_log, Bm, Cm, chunk, split=False):
    """The SSD kernel's four steps in plain torch, in f32 (y rounded once to
    x's dtype): C·Bᵀ per (batch, chunk, group); each chunk's own state
    s_c = Σ_j x_j ⊗ (w_j B_j), w_j = dt_j exp(ca_last − ca_j); the pass
    across chunks, hprev[c] = h, h = exp(ca_last_c) h + s_c; and the chunk
    scan y = (CB ∘ decay ∘ dt)·x + exp(ca_i) C·hprevᵀ. ``split`` rounds
    each product's operands to bf16 hi/lo pairs as the kernel's tensor-core
    products do. Shapes and result as ``ssd_ref``. Nothing on the serve path
    calls it: the tests hold the dataflow against the JAX package with it,
    on the CPU, where the CUDA kernel cannot run."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc, q, hpg = (s + pad) // chunk, chunk, h // g
    xc = x.float().reshape(b, nc, q, h, p)
    Bc = Bm.float().reshape(b, nc, q, g, n)
    Cc = Cm.float().reshape(b, nc, q, g, n)
    dtc = dt.float().reshape(b, nc, q, h)
    ca = torch.cumsum(-torch.exp(A_log.float()) * dtc, dim=2)  # (b, nc, q, h)
    ca_last = ca[:, :, -1]  # (b, nc, h)

    # 1. C·Bᵀ per (batch, chunk, group)
    cb = _product("bcign,bcjgn->bcgij", Cc, Bc, split)
    # 2. each chunk's own state
    w = dtc * torch.exp(ca_last[:, :, None] - ca)  # (b, nc, q, h)
    wB = w[..., None] * torch.repeat_interleave(Bc, hpg, dim=3)  # (b, nc, q, h, n)
    s_c = _product("bcjhp,bcjhn->bchpn", xc, wB, split)
    # 3. the pass across chunks
    hs = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    hprev = []
    for c in range(nc):
        hprev.append(hs)
        hs = torch.exp(ca_last[:, c])[..., None, None] * hs + s_c[:, c]
    hprev = (torch.stack(hprev, dim=1) if hprev
             else x.new_zeros((b, 0, h, p, n), dtype=torch.float32))
    # 4. the chunk scan; the decay only for j <= i, so no inf is formed
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    seg = ca[:, :, :, None, :] - ca[:, :, None, :, :]  # (b, nc, i, j, h)
    decay = torch.exp(torch.where(mask[None, None, :, :, None], seg, float("-inf")))
    scores = (torch.repeat_interleave(cb, hpg, dim=2) * decay.permute(0, 1, 4, 2, 3)
              * dtc.permute(0, 1, 3, 2)[:, :, :, None, :])  # (b, nc, h, i, j)
    y = _product("bchij,bcjhp->bcihp", scores, xc, split)
    Ch = torch.repeat_interleave(Cc, hpg, dim=3)  # (b, nc, q, h, n)
    y = y + _product("bcihn,bchpn->bcihp", Ch, hprev, split) * torch.exp(ca)[..., None]
    return y.reshape(b, nc * q, h, p)[:, :s].to(x.dtype), hs


def _cum(v: torch.Tensor, op: str) -> torch.Tensor:
    if op == "sum":
        return torch.cumsum(v, dim=0, dtype=v.dtype)
    if op == "max":
        return torch.cummax(v, dim=0).values
    if op == "min":
        return torch.cummin(v, dim=0).values
    raise ValueError(f"prefix scan op must be sum/max/min, got {op!r}")


def prefix_scan_ref(x: torch.Tensor, op: str = "sum", reverse: bool = False):
    """Inclusive scan; ``reverse=True`` scans from the tail (suffix scan).
    Bool rides as i32 and is cast back."""
    v = x.to(torch.int32) if x.dtype == torch.bool else x
    if reverse:
        v = torch.flip(v, dims=(0,))
    out = _cum(v, op)
    if reverse:
        out = torch.flip(out, dims=(0,))
    return out.to(torch.bool) if x.dtype == torch.bool else out


def _pick(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The prefix kernel's combine of ``a`` (earlier) and ``b`` (later):
    for float max/min torch.cummax's and cummin's rule — a NaN wins, and of
    two equal values (two NaNs, or -0 and +0) the later is kept."""
    if op == "sum":
        return a + b
    if not a.dtype.is_floating_point:
        return torch.maximum(a, b) if op == "max" else torch.minimum(a, b)
    later = b >= a if op == "max" else b <= a
    return torch.where(torch.isnan(b) | (~torch.isnan(a) & later), b, a)


def prefix_scan_lookback(x: torch.Tensor, op: str = "sum", reverse: bool = False,
                         tile: int = 8192) -> torch.Tensor:
    """The CUDA prefix scan's dataflow (``prefix_scan_fwd`` in
    ``csrc/segment_reduce.cu``) in plain torch, with ``tile`` rows per tile:
    tiles are cut from the head of the array in either direction (the last
    one ragged) and taken in the look-back's order, last first under
    ``reverse``; each tile's own scan (from its high end under ``reverse``)
    and its aggregate (the scan's last row in that order); each tile's
    exclusive prefix from the walk back over the aggregates of the tiles
    before it in that order, which never meets a published prefix here, as
    if no tile before had finished, and walks to the first; then every row
    of the tile combined with that prefix. Same arguments and result as
    ``prefix_scan_ref``. Nothing on the main path calls it: the tests hold
    the dataflow against the JAX kernel with it, on the CPU, where the CUDA
    kernel cannot run."""
    v = x.to(torch.int32) if x.dtype == torch.bool else x
    starts = list(range(0, v.shape[0], tile))
    if reverse:
        starts.reverse()
    scans = []
    for a in starts:
        t = v[a:a + tile]
        scans.append(torch.flip(_cum(torch.flip(t, dims=(0,)), op), dims=(0,)) if reverse
                     else _cum(t, op))
    aggs = [sc[0] if reverse else sc[-1] for sc in scans]
    out = scans[:1]
    for t in range(1, len(scans)):
        pre = None
        for i in range(t - 1, -1, -1):
            pre = aggs[i] if pre is None else _pick(op, aggs[i], pre)
        out.append(_pick(op, pre, scans[t]))
    if reverse:
        out.reverse()
    res = torch.cat(out) if out else v.clone()
    return res.to(torch.bool) if x.dtype == torch.bool else res
