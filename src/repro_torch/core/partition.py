"""Partition model (paper §3.8).

A *Block* is the unit of lineage: a row tree of tensors sharing a leading
row dim (padded to the executor count) plus a validity mask — the
fixed-shape dataflow representation (filters mask, they don't compact;
compaction happens at shuffles and at the driver boundary).

Executors are ``p`` virtual ranks on one torch device. A block's leaves are
flat ``(N, …)`` tensors read rank-major: rank ``r`` holds rows
``[r·N/p, (r+1)·N/p)`` — the rows a JAX block row-sharded over ``p``
devices keeps on device ``r``, in the same order. Wide stages view them as
``(p, N/p, …)``.

A block also records the world ranks it is committed to (``ranks``): the
counterpart of the device set a JAX block's sharding spans. Blocks built
under a communicator carry its ranks; ``None`` marks a host or uncommitted
block. Wide stages and the elastic mesh's move/keep rule key on it.

Row trees: scalars, tuples, dicts (``core/tree.py``). KV rows are
``{"key": k, "value": v}``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import tree

# the reference runs without 64-bit mode: host data narrows to 32 bits
_CANON = {np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32,
          np.dtype(np.float64): np.float32, np.dtype(np.complex128): np.complex64}


@dataclass
class Block:
    data: Any  # row tree of tensors, leading dim N (equal across leaves)
    valid: torch.Tensor  # bool[N]
    # world ranks the block is committed to, in the communicator's order
    # (None: host or uncommitted)
    ranks: Optional[tuple] = None

    @property
    def capacity(self) -> int:
        return tree.leaves(self.data)[0].shape[0]

    @property
    def device(self) -> torch.device:
        return self.valid.device


def block_aval(block: "Block") -> tuple:
    """Hashable shape/dtype summary of a Block — the cache-key half that
    makes a compiled plan (narrow or wide) reusable only for compatible
    block geometry. Shared by the DAG plan cache, the shuffle engine's
    wide-plan cache, and source-node lineage signatures."""
    leaves, treedef = tree.flatten(block.data)
    return (
        treedef,
        tuple((tuple(l.shape), str(l.dtype)) for l in leaves),
        tuple(block.valid.shape),
    )


def rows_of(data) -> int:
    return tree.leaves(data)[0].shape[0]


def pad_to(n: int, p: int) -> int:
    return ((n + p - 1) // p) * p


def canonical(x) -> np.ndarray:
    """Host array in the reference's 32-bit dtypes."""
    a = np.asarray(x)
    t = _CANON.get(a.dtype)
    return a.astype(t) if t is not None else a


def from_host(rows, p: int, device="cpu", ranks: Optional[tuple] = None) -> Block:
    """Build a Block on ``device`` from host data (list of row trees or a
    tree of stacked arrays). Pads rows to a multiple of p. ``ranks``: the
    communicator's ranks the block is committed to."""
    if isinstance(rows, list):
        data = tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *rows)
    else:
        data = rows
    data = tree.map(lambda x: x if isinstance(x, torch.Tensor) else canonical(x), data)
    n = rows_of(data)
    cap = max(pad_to(n, p), p)
    pad = cap - n

    def put(x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        t = t.to(device)
        if pad:
            t = torch.cat([t, t.new_zeros((pad, *t.shape[1:]))])
        return t

    data = tree.map(put, data)
    valid = torch.arange(cap, device=device) < n
    return Block(data, valid, None if ranks is None else tuple(ranks))


def to_host(block: Block):
    """Compact a Block to a host list of valid row trees (driver boundary)."""
    valid = block.valid.cpu().numpy()
    idx = np.nonzero(valid)[0]
    leaves, treedef = tree.flatten(block.data)
    cols = [list(l.cpu().numpy()[idx]) for l in leaves]
    return [tree.unflatten(treedef, [np.asarray(c[j]) for c in cols])
            for j in range(len(idx))]


def block_ranks(block: Block) -> Optional[frozenset]:
    """The rank set a Block is committed to (None for host/uncommitted)."""
    return None if block.ranks is None else frozenset(block.ranks)


def place_block(block: Block, ctx) -> Block:
    """Commit a Block to communicator ``ctx`` — the inter-worker /
    inter-group reshard edge: its tensors move to ``ctx.device`` (virtual
    ranks share one device, so on the same device nothing is copied) and
    the block records ``ctx.ranks``."""
    ranks = tuple(ctx.ranks)
    if block.device == ctx.device and block.ranks == ranks:
        return block
    dev = ctx.device
    return Block(tree.map(lambda x: x.to(dev), block.data), block.valid.to(dev), ranks)


def concat_blocks(blocks: list[Block]) -> Block:
    if len(blocks) == 1:
        return blocks[0]
    dev = blocks[0].device
    if any(b.device != dev for b in blocks[1:]):
        raise ValueError(f"concat_blocks: blocks live on different devices "
                         f"{sorted({str(b.device) for b in blocks})}")
    data = tree.map(lambda *xs: torch.cat(xs, dim=0), *[b.data for b in blocks])
    valid = torch.cat([b.valid for b in blocks], dim=0)
    ranks = next((b.ranks for b in blocks if b.ranks is not None), None)
    return Block(data, valid, ranks)


def split_block(block: Block, k: int, p: int) -> list[Block]:
    """Split into k blocks with per-block capacity a multiple of p."""
    n = block.capacity
    per = max(pad_to((n + k - 1) // k, p), p)
    out = []
    for i in range(k):
        lo = i * per
        if lo >= n:
            data = tree.map(lambda x: x.new_zeros((p, *x.shape[1:])), block.data)
            out.append(Block(data, block.valid.new_zeros((p,)), block.ranks))
            continue
        hi = min(lo + per, n)
        data = tree.map(lambda x: x[lo:hi], block.data)
        out.append(Block(data, block.valid[lo:hi], block.ranks))
    return out
