"""Plain torch versions of the MoE router kernel and of the bucket-route
kernel, and mirrors of both kernels' one-pass dataflows
(``moe_route_lookback``, ``bucket_route_lookback``). The router's ordinals
match ``models.moe.moe_ffn``: assignments are ranked within their expert in
flattened (token-major, slot-minor) order."""
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


def _peer_groups(b: torch.Tensor):
    """For one warp's round of rows (lane i holds row i, bucket ``b[i]``):
    each lane's peer mask (the lanes with its bucket: the kernel's ballots),
    its rank among them (the peers below it: ``__popc(peers & lower)``),
    whether it leads its group (its lowest peer) and the group's size."""
    m = b.shape[0]
    peers = b[:, None] == b[None, :]
    lane = torch.arange(m, device=b.device)
    lower = lane[None, :] < lane[:, None]
    rank = (peers & lower).sum(1)
    leads = peers.int().argmax(1) == lane
    return rank, leads, peers.sum(1)


def bucket_route_lookback(dest: torch.Tensor, p: int, capacity: int, tile: int = 8192,
                          warps: int = 16):
    """The CUDA bucket router's dataflow (``csrc/bucket_route.cu``) in plain
    torch, with ``tile`` rows per tile and ``warps`` warps a tile, each warp
    owning ``tile / warps`` consecutive rows that it walks 32 at a time: a
    first walk counts each bucket's rows per warp in the warp's table; an
    exclusive scan over the warps, per bucket, turns the table into each
    warp's base in the tile, and the count carried into the tile per bucket
    comes from the walk back over the aggregates of the tiles before it
    (which never meets a published prefix here, as if no tile before had
    finished, and walks to the first); a second walk gives each row its
    warp's base plus its rank among its peers, the leader advancing the base
    by its group. A row to
    the sentinel ``p`` (or past it) takes pos 0, keep false and counts
    nowhere. Same arguments and result as ``bucket_route_ref``. Nothing on
    the main path calls it: the tests hold the dataflow against the JAX
    kernel with it, on the CPU, where the CUDA kernel cannot run."""
    if tile % (32 * warps):
        raise ValueError(f"a tile is whole rounds of 32 rows for each of its {warps} warps, "
                         f"got {tile} rows")
    n, dev = dest.shape[0], dest.device
    d = dest.long()
    routed = (d >= 0) & (d < p)
    b_all = torch.where(routed, d, p)  # unrouted rows: column p, never read
    per_warp = tile // warps
    pos = torch.zeros(n, dtype=torch.int32, device=dev)
    tables, aggs = [], []
    for a in range(0, n, tile):  # 1. each warp's count per bucket; 2. its base
        table = torch.zeros((warps, p + 1), dtype=torch.int64, device=dev)
        for w in range(warps):
            for r in range(a + w * per_warp, min(a + (w + 1) * per_warp, n), 32):
                b = b_all[r:min(r + 32, a + (w + 1) * per_warp, n)]
                table[w].index_add_(0, b, torch.ones_like(b))  # a row each
        aggs.append(table.sum(0)[:p])
        tables.append(torch.cumsum(table, 0) - table)
    carried = torch.zeros(p, dtype=torch.int64, device=dev)
    for t, (a, base) in enumerate(zip(range(0, n, tile), tables)):
        carried = torch.zeros(p, dtype=torch.int64, device=dev)
        for i in range(t - 1, -1, -1):  # 3. the look-back, per bucket
            carried = aggs[i] + carried
        base[:, :p] += carried
        for w in range(warps):  # 4. the ordinals
            for r in range(a + w * per_warp, min(a + (w + 1) * per_warp, n), 32):
                b = b_all[r:min(r + 32, a + (w + 1) * per_warp, n)]
                rank, leads, size = _peer_groups(b)
                pos[r:r + b.shape[0]] = (base[w, b] + rank).to(torch.int32)
                base[w].index_add_(0, b[leads], size[leads])
    counts = (carried + aggs[-1]) if aggs else carried
    pos = torch.where(routed, pos, 0)
    return pos, routed & (pos < capacity), counts.to(torch.int32)


def _top_k(logits: torch.Tensor, k: int):
    """(weights (T, k) f32 renormalised, idx (T, k) int64) of the router.

    The softmax is ``exp(l - max) / sum`` with the sum taken column by
    column, as the kernel takes it, and the renormalising sum slot by slot.
    Top-k is an iterative argmax over the probabilities (``torch.argmax``
    returns the first maximum, so the lower expert index wins a tie, as
    with ``jax.lax.top_k``, and it ranks NaN highest, so a row of NaN
    probabilities routes to experts 0, 1, ...); ``torch.topk`` does not
    promise that order."""
    E = logits.shape[1]
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
    total = ws[0]
    for x in ws[1:]:  # slot by slot, as the kernel sums
        total = total + x
    return w / torch.clamp_min(total, 1e-9), idx


def _ordinals(idx: torch.Tensor, E: int):
    """(T·k, E) one-hot of the flattened assignments and each one's ordinal
    within its expert among them (token-major, slot-minor)."""
    oh = F.one_hot(idx.reshape(-1), E).to(torch.int32)
    csum = torch.cumsum(oh, dim=0, dtype=torch.int32)
    return oh, ((csum - oh) * oh).sum(-1, dtype=torch.int32)


def moe_route_ref(logits: torch.Tensor, k: int, capacity: int):
    """logits: (T, E). Returns (weights (T,k) f32, idx (T,k) i32, pos (T,k)
    i32 ordinal-within-expert, keep (T,k) bool). The experts and weights are
    ``_top_k``'s."""
    T, E = logits.shape
    w, idx = _top_k(logits, k)
    pos = _ordinals(idx, E)[1].reshape(T, k)
    return w, idx.to(torch.int32), pos, pos < capacity


def moe_route_lookback(logits: torch.Tensor, k: int, capacity: int, tile: int = 256):
    """The CUDA kernel's dataflow (``csrc/moe_route.cu``) in plain torch,
    with ``tile`` tokens per tile: each tile routes its tokens, ranks its
    assignments within their experts and counts them per expert (its
    aggregate, an E-vector); each tile's base per expert is the sum of the
    aggregates of the tiles before it, from the walk back over them (which,
    as if no tile before had finished, never meets a published prefix and
    walks to the first tile); an ordinal is its expert's base plus its rank
    in the tile. Same arguments and result as ``moe_route_ref``. Nothing on
    the serve path calls it: the tests hold the dataflow against the JAX
    kernel with it, on the CPU, where the CUDA kernel cannot run."""
    T, E = logits.shape
    w, idx = _top_k(logits, k)
    ranks, aggs = [], []
    for a in range(0, T, tile):
        oh, rank = _ordinals(idx[a:a + tile], E)
        ranks.append(rank)
        aggs.append(oh.sum(0, dtype=torch.int32))
    pos = []
    for t, rank in enumerate(ranks):
        base = torch.zeros(E, dtype=torch.int32, device=logits.device)
        for i in range(t - 1, -1, -1):
            base = aggs[i] + base
        pos.append(base[idx[t * tile:(t + 1) * tile].reshape(-1)] + rank)
    pos = (torch.cat(pos) if pos else torch.zeros(0, dtype=torch.int32)).reshape(T, k)
    return w, idx.to(torch.int32), pos, pos < capacity
