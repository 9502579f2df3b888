"""Plain torch versions of the MoE router kernel and of the bucket-route
kernel. The router's ordinals match ``models.moe.moe_ffn``: assignments are
ranked within their expert in flattened (token-major, slot-minor) order."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def bucket_route_ref(dest: torch.Tensor, p: int, capacity: int):
    """Capacity ordinals by the stable-argsort formulation (the exact code
    path of core/shuffle._pack_exchange, inverted back to row order).
    dest: (N,) int32 in [0, p]; ``p`` is the padding sentinel, which claims
    no ordinal and adds to no count."""
    n = dest.shape[0]
    d = dest.long()
    order = torch.sort(d, stable=True).indices
    ds = d[order]
    counts_all = torch.bincount(ds, minlength=p + 1)
    starts = torch.cumsum(counts_all, 0) - counts_all
    pos_sorted = torch.arange(n, device=dest.device) - starts[ds]
    pos = torch.empty(n, dtype=torch.int32, device=dest.device)
    pos[order] = pos_sorted.to(torch.int32)
    routed = dest < p
    pos = torch.where(routed, pos, 0)  # the kernel's one-hot of p is empty
    keep = (pos < capacity) & routed
    return pos, keep, counts_all[:p].to(torch.int32)


def moe_route_ref(logits: torch.Tensor, k: int, capacity: int):
    """logits: (T, E). Returns (weights (T,k) f32, idx (T,k) i32, pos (T,k)
    i32 ordinal-within-expert, keep (T,k) bool).

    The softmax is ``exp(l - max) / sum`` with the sum taken column by
    column, as the kernel takes it. Top-k is an iterative argmax over the
    probabilities (``torch.argmax`` returns the first maximum, so the lower
    expert index wins a tie, as with ``jax.lax.top_k``, and it ranks NaN
    highest, so a row of NaN probabilities routes to experts 0 and 1);
    ``torch.topk`` does not promise that order."""
    T, E = logits.shape
    lf = logits.float()
    e = torch.exp(lf - lf.max(dim=-1, keepdim=True).values)
    s = e[:, 0]
    for j in range(1, E):
        s = s + e[:, j]
    probs = e / s[:, None]
    rem, ws, ids = probs, [], []
    for _ in range(k):
        i = torch.argmax(rem, dim=-1, keepdim=True)
        ws.append(torch.gather(rem, 1, i))
        ids.append(i)
        rem = rem.scatter(1, i, float("-inf"))
    w = torch.cat(ws, dim=1)
    idx = torch.cat(ids, dim=1)
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    oh = F.one_hot(idx.reshape(-1), E).to(torch.int32)  # (T·k, E)
    csum = torch.cumsum(oh, dim=0, dtype=torch.int32)
    pos = ((csum - oh) * oh).sum(-1, dtype=torch.int32).reshape(T, k)
    return w, idx.to(torch.int32), pos, pos < capacity
