"""Wide (shuffle-backed) operators batched over the rank axis (paper §3.6,
§6.2).

* PSRS distributed sort — Parallel Sorting by Regular Sampling, the
  algorithm the paper uses for TeraSort: local sort → regular samples →
  all-gather → global pivots → bucket → all_to_all → local merge.
* hash exchange — reduceByKey/join/partitionBy routing (MPI_Alltoall).
* sorted segmented reduce — log-depth segmented scan over key runs (the
  plain path beside the segment kernel).
* sort-merge join with bounded fan-out.

Every stage takes flat rank-major tensors — rank ``r`` of ``p`` holds rows
``[r·n, (r+1)·n)`` — and runs every rank at once: the reference's
``shard_map`` bodies become code over ``(p, n, …)`` views, a per-rank sort
is a sort along dim 1, ``all_to_all`` is a transpose of
``(p_src, p_dst, C, …)``, ``psum``/``pmax`` are reductions over every rank.

All fixed-shape: buckets are capacity-padded, overflow is *detected*,
never silently dropped. Every stage returns device scalars
``(overflow, max_fill)`` alongside its data; the adaptive shuffle engine
(shuffle_plan.py) performs one deferred host check per wide node.

Stages take a ``post`` hook ``post(keys, valid, data, seg)`` — a per-rank
transform over the flat post-exchange rows, ``seg`` rows per rank — so
sort→segment-heads→segmented-reduce chains (reduceByKey, distinct,
groupByKey) run as ONE wide stage. Post hooks are valid because PSRS/hash
routing sends equal keys to one rank, and every hook marks each rank's row
0 as a segment start: no key segment ever spans a rank boundary.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import tree
from repro_torch.core.context import IContext
from repro_torch.kernels.segment_reduce.ref import heads_of as segment_heads


def _sentinel(dtype):
    """Largest value of dtype — sorts invalid rows to the tail."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def _sentinel_low(dtype):
    """Smallest value of dtype — masks invalid rows out of an argmax."""
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    """splitmix-style avalanche on int keys → uint32 values in int64.

    Torch has no uint32 ``>>``/``%`` on the CPU, so the hash runs in int64:
    masking to 32 bits reinterprets negative keys as the reference's
    ``astype(uint32)`` does, and re-masking after each multiply keeps the
    low 32 bits of the wrapped product."""
    m = 0xFFFFFFFF
    h = x.to(torch.int64) & m
    h = ((h ^ (h >> 16)) * 0x7FEB352D) & m
    h = ((h ^ (h >> 15)) * 0x846CA68B) & m
    return h ^ (h >> 16)


def _hash_dest(keys, valid, p: int) -> torch.Tensor:
    dest = (_hash_u32(keys) % p).to(torch.int32)
    return torch.where(valid, dest, p - 1)  # park invalid rows anywhere stable


def capacity_for(factor: float, n_local: int, p: int) -> int:
    """Per-destination bucket capacity for a given capacity factor.

    ``factor = p`` is the worst case: C = n_local fits even when every row
    of a rank routes to one destination."""
    return max(int(math.ceil(factor * n_local / p)), 1)


def _rank_base(p: int, n: int, device) -> torch.Tensor:
    """(p, 1) offsets of each rank's first row in a flat layout."""
    return torch.arange(p, device=device)[:, None] * n


def _rank_sort(x2: torch.Tensor):
    """Stable sort of every rank's row: (sorted (p, n), flat row order)."""
    p, n = x2.shape
    vals, order = torch.sort(x2, dim=1, stable=True)
    return vals, (order + _rank_base(p, n, x2.device)).reshape(-1)


# ---------------------------------------------------------------------------
# pack-by-destination + all_to_all  (shared by PSRS and hash exchange)
# ---------------------------------------------------------------------------


def _pack_exchange(dest, payload, p: int, C: int, route=None):
    """Route every rank's rows to `dest` buckets with capacity C.

    dest: (p, n) int in [0, p); payload: tree of flat (p·n, …) leaves (must
    include its own validity leaf). Returns (tree of flat (p·p·C, …) — rank
    j holds, per source rank in order, the C slots sent to it — overflow,
    max_fill). Dropped rows (bucket overflow) are counted, not silently
    lost; max_fill is the largest bucket demand observed.

    ``route`` (optional) is the kernel-backed router ``dest -> (pos, keep,
    counts)``: capacity ordinals in row order — exactly the rank the stable
    argsort below assigns, so kept rows land in the same unique slots and
    the packed buffer is bit-identical. Overflowed rows all write the
    scratch slot (duplicate indices, so its value is arbitrary); it is
    sliced off before anything reads the buffer.
    """
    _, n = dest.shape
    dev = dest.device
    if route is not None:
        pos, keep, counts = route(dest)
        src_rows = None  # rows scatter from row order directly
        slot = torch.where(keep, dest * C + pos, p * C)
    else:
        ds, src_rows = _rank_sort(dest)
        ds = ds.long()
        counts = torch.zeros((p, p), dtype=torch.int64, device=dev)
        counts.scatter_add_(1, ds, torch.ones_like(ds))
        starts = torch.cumsum(counts, dim=1) - counts
        pos = torch.arange(n, device=dev) - torch.gather(starts, 1, ds)
        keep = pos < C
        slot = torch.where(keep, ds * C + pos, p * C)  # overflow → scratch
    overflow = (p * n - keep.sum()).to(torch.int32)
    max_fill = counts.max().to(torch.int32)
    width = p * C + 1
    flat_slot = (slot.long() + _rank_base(p, width, dev)).reshape(-1)

    def pack(x):
        xs = x if src_rows is None else x[src_rows]
        rest = x.shape[1:]
        buf = x.new_zeros((p * width, *rest))
        buf[flat_slot] = xs
        buf = buf.view(p, width, *rest)[:, : p * C]
        y = buf.reshape(p, p, C, *rest).transpose(0, 1)  # (p_dst, p_src, C, …)
        return y.reshape(p * p * C, *rest)

    return tree.map(pack, payload), overflow, max_fill


# ---------------------------------------------------------------------------
# fused wide stages (PSRS sort / hash exchange + per-rank post-transform)
# ---------------------------------------------------------------------------


def _passthrough(k, v, d, seg):
    return d, v


def sort_stage(ctx: IContext, keys, valid, data, C: int, post=None):
    """One fused wide sort stage over every rank, no host syncs.

    PSRS exchange + local merge + ``post``. Returns ``(post_out, overflow,
    max_fill)`` — the scalars are int32 device values; the caller decides
    when (if ever) to sync on them."""
    post = post or _passthrough
    p = ctx.executors
    dev = keys.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    big = _sentinel(keys.dtype)
    if p == 1:
        order = torch.sort(torch.where(valid, keys, big), stable=True).indices
        out = post(keys[order], valid[order], tree.map(lambda x: x[order], data),
                   keys.shape[0])
        return out, zero, zero

    n_local = keys.shape[0] // p
    ks = torch.where(valid, keys, big).view(p, n_local)
    ks, rows = _rank_sort(ks)
    payload = {"k": keys[rows], "valid": valid[rows],
               "data": tree.map(lambda x: x[rows], data)}
    # regular sampling: p evenly spaced samples per rank, gathered by all
    idx = (torch.arange(1, p + 1, device=dev) * n_local) // (p + 1)
    all_samples = ks[:, idx].reshape(-1)  # (p·p,) rank-major
    pivots = torch.sort(all_samples).values[p - 1:: p][: p - 1].contiguous()
    dest = torch.searchsorted(pivots, ks, right=True).to(torch.int32)
    out, overflow, fill = _pack_exchange(dest, payload, p, C)
    # local merge
    m = p * C
    km = torch.where(out["valid"], out["k"], big).view(p, m)
    _, rows2 = _rank_sort(km)
    res = tree.map(lambda x: x[rows2], out)
    return post(res["k"], res["valid"], res["data"], m), overflow, fill


def hash_stage(ctx: IContext, keys, valid, data, C: int, post=None, route=None):
    """One fused wide hash-exchange stage (partitionBy / reduce routing), no
    host syncs. Same contract as ``sort_stage``; equal keys land on one
    rank but arrive unsorted. ``route`` is the optional kernel-backed bucket
    router (see ``_pack_exchange``)."""
    post = post or _passthrough
    p = ctx.executors
    zero = torch.zeros((), dtype=torch.int32, device=keys.device)
    if p == 1:
        return post(keys, valid, data, keys.shape[0]), zero, zero
    n_local = keys.shape[0] // p
    dest = _hash_dest(keys, valid, p).view(p, n_local)
    payload = {"k": keys, "valid": valid, "data": data}
    out, overflow, fill = _pack_exchange(dest, payload, p, C, route)
    return post(out["k"], out["valid"], out["data"], p * C), overflow, fill


def join_stage(ctx: IContext, lk, lvalid, lvals, rk, rvalid, rvals,
               Cl: int, Cr: int, M: int, route_l=None, route_r=None):
    """Both-side hash exchange + per-rank sort-merge join in ONE wide stage.

    Returns ``(rows, ok, exch_overflow, lfill, rfill, fan_overflow)`` — four
    int32 device scalars fetched by the caller in a single deferred sync.
    ``route_l`` / ``route_r`` are per-side kernel-backed bucket routers
    (capacity-specific: Cl ≠ Cr)."""
    p = ctx.executors
    zero = torch.zeros((), dtype=torch.int32, device=lk.device)
    if p == 1:
        rows, ok, fovf = local_join(lk, lvalid, lvals, rk, rvalid, rvals, M)
        return rows, ok, zero, zero, zero, fovf.to(torch.int32)
    nl, nr = lk.shape[0] // p, rk.shape[0] // p
    ldest = _hash_dest(lk, lvalid, p).view(p, nl)
    rdest = _hash_dest(rk, rvalid, p).view(p, nr)
    lout, lovf, lfill = _pack_exchange(
        ldest, {"k": lk, "valid": lvalid, "data": lvals}, p, Cl, route_l)
    rout, rovf, rfill = _pack_exchange(
        rdest, {"k": rk, "valid": rvalid, "data": rvals}, p, Cr, route_r)
    rows, ok, fovf = local_join(
        lout["k"], lout["valid"], lout["data"],
        rout["k"], rout["valid"], rout["data"], M, p=p)
    return rows, ok, lovf + rovf, lfill, rfill, fovf.to(torch.int32)


# ---------------------------------------------------------------------------
# legacy single-shot wrappers (direct-primitive tests; no retry, no memory)
# ---------------------------------------------------------------------------


def psrs_sort(ctx: IContext, keys, valid, data, capacity_factor=2.0):
    """Distributed sort by `keys` over every rank. Returns (keys', valid',
    data', overflow) — globally sorted (rank i holds keys ≤ rank i+1),
    invalid rows pushed to the tail of each rank."""
    p = ctx.executors
    C = capacity_for(capacity_factor, keys.shape[0] // max(p, 1), p)
    out, ovf, _ = sort_stage(ctx, keys, valid, data, C,
                             post=lambda k, v, d, s: (k, v, d))
    k, v, d = out
    return k, v, d, ovf


def hash_exchange(ctx: IContext, keys, valid, data, capacity_factor=2.0):
    """Route rows so equal keys land on the same rank. Same-shape padded
    output + overflow count."""
    p = ctx.executors
    if p == 1:
        return keys, valid, data, torch.zeros((), dtype=torch.int32,
                                              device=keys.device)
    C = capacity_for(capacity_factor, keys.shape[0] // p, p)
    out, ovf, _ = hash_stage(ctx, keys, valid, data, C,
                             post=lambda k, v, d, s: (k, v, d))
    k, v, d = out
    return k, v, d, ovf


# ---------------------------------------------------------------------------
# sorted segmented reduce (the plain path beside kernels/segment_reduce)
# ---------------------------------------------------------------------------


def _bcast(mask, x):
    return mask.reshape((-1,) + (1,) * (x.ndim - 1))


def _segmented_scan(fn, vals, flags):
    """Inclusive segmented scan of a row tree under ``fn`` (Hillis–Steele,
    log depth): a flagged row starts a new segment."""
    n = flags.shape[0]
    v, f = vals, flags
    off = 1
    while off < n:
        comb = fn(tree.map(lambda x: x[:-off], v), tree.map(lambda x: x[off:], v))
        keep = f[off:]
        v = tree.map(lambda x, c: torch.cat(
            [x[:off], torch.where(_bcast(keep, c), x[off:], c)]), v, comb)
        f = torch.cat([f[:off], f[off:] | f[:-off]])
        off *= 2
    return v


def segmented_reduce(keys, valid, values, fn, identity, seg=None):
    """Reduce consecutive equal-key runs (keys sorted per rank, invalid at
    arbitrary positions; ``seg`` rows per rank). Returns (head_mask,
    reduced_values broadcast to every row of the run).

    fn: associative binary row fn (trees); identity: row tree.
    """
    n = keys.shape[0]
    heads = segment_heads(keys, valid, seg)
    heads_ext = heads | ~valid

    vals = tree.map(
        lambda x, i: torch.where(
            _bcast(valid, x), x, torch.as_tensor(i, device=x.device).to(x.dtype)),
        values, identity)
    scanned = _segmented_scan(fn, vals, heads_ext)
    # last row of each segment = (next head_ext) - 1
    idx = torch.arange(n, device=keys.device)
    head_pos = torch.where(heads_ext, idx, n)
    suff_min = torch.flip(torch.cummin(torch.flip(head_pos, (0,)), 0).values, (0,))
    nxt = torch.cat([suff_min[1:], suff_min.new_full((1,), n)])
    last_pos = torch.clamp(torch.where(nxt >= n, n - 1, nxt - 1), 0, n - 1)
    out = tree.map(lambda s: s[last_pos], scanned)
    return heads, out


# ---------------------------------------------------------------------------
# post hooks: the sort→heads→reduce fusion targets
# ---------------------------------------------------------------------------


def heads_post(keys, valid, data, seg):
    """distinct: keep the first row of every equal-key run."""
    return data, segment_heads(keys, valid, seg)


def make_reduce_post(fn, identity):
    """reduceByKey: segmented reduce fused into the sort stage."""

    def post(keys, valid, data, seg):
        heads, red = segmented_reduce(keys, valid, data["value"], fn, identity, seg)
        return {"key": data["key"], "value": red}, heads

    return post


def make_reduce_post_kernel(op: str, identity, block: int):
    """reduceByKey on the kernel tier: the segment scan + prefix kernels
    replace ``segmented_reduce``, fused into the same wide stage, one launch
    each over every rank. Only built for values the registry recognized as
    a single supported-dtype leaf with a builtin op."""
    from repro_torch.kernels.segment_reduce.ops import segment_totals

    def post(keys, valid, data, seg):
        leaves, treedef = tree.flatten(data["value"])
        ident = tree.leaves(identity)[0]
        heads, red = segment_totals(keys, valid, leaves[0], op=op,
                                    identity=ident, block=block, seg=seg)
        value = tree.unflatten(treedef, [red])
        return {"key": data["key"], "value": value}, heads

    return post


def make_bucket_route(p: int, C: int, block: int):
    """Kernel-backed exchange router for ``_pack_exchange``: routes every
    source rank in ONE launch through composite destinations
    ``rank·p + dest`` over ``p·p`` buckets."""
    from repro_torch.kernels.moe_route.ops import bucket_route

    def route(dest):
        ps, n = dest.shape
        comp = (dest + _rank_base(ps, p, dest.device)).to(torch.int32)
        pos, keep, counts = bucket_route(comp.reshape(-1), ps * p, C, block=block)
        return pos.view(ps, n), keep.view(ps, n), counts.view(ps, p)

    return route


def make_group_post(G: int):
    """groupByKey: G-bounded gather of each key run, fused into the sort
    stage. Rows (key, {items[G], mask[G], count}) at segment heads."""

    def post(keys, valid, data, seg):
        heads = segment_heads(keys, valid, seg)
        n = keys.shape[0]
        idx = torch.arange(n, device=keys.device)
        raw = idx[:, None] + torch.arange(G, device=keys.device)[None, :]
        end = (idx // seg + 1) * seg  # exclusive end of the row's rank
        gidx = torch.minimum(raw, end[:, None] - 1)
        same = (keys[gidx] == keys[:, None]) & valid[gidx] & (raw < end[:, None])
        vals = tree.map(lambda x: x[gidx], data["value"])
        counts = same.sum(-1, dtype=torch.int32)
        return (
            {"key": data["key"], "value": {"items": vals, "mask": same, "count": counts}},
            heads,
        )

    return post


# ---------------------------------------------------------------------------
# per-rank (post-exchange) join with bounded fan-out
# ---------------------------------------------------------------------------


def local_join(lk, lvalid, lvals, rk, rvalid, rvals, max_matches: int, p: int = 1):
    """Sort-merge join on every rank. Returns dict rows of capacity
    n_left·M per rank, rank-major."""
    big = _sentinel(rk.dtype)
    nl, nr = lk.shape[0] // p, rk.shape[0] // p
    dev = lk.device
    rs, rows = _rank_sort(torch.where(rvalid, rk, big).view(p, nr))
    rv = tree.map(lambda x: x[rows], rvals)
    rvalid_s = rvalid[rows]

    lk2 = lk.view(p, nl).to(rs.dtype)
    lo = torch.searchsorted(rs, lk2, right=False)
    hi = torch.searchsorted(rs, lk2, right=True)
    M = max_matches
    j = lo[..., None] + torch.arange(M, device=dev)  # (p, n_left, M)
    ok = (j < hi[..., None]) & lvalid.view(p, nl)[..., None]
    jc = torch.clamp(j, 0, nr - 1) + _rank_base(p, nr, dev)[..., None]
    jc = jc.reshape(-1)
    ok = ok & rvalid_s[jc].view(p, nl, M)
    out_overflow = torch.clamp(hi - lo - M, min=0).sum()

    def expand_l(x):
        return torch.repeat_interleave(x, M, dim=0)

    rows_out = {
        "key": expand_l(lk),
        "value": (tree.map(expand_l, lvals), tree.map(lambda x: x[jc], rv)),
    }
    return rows_out, ok.reshape(-1), out_overflow
