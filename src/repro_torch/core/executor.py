"""Executor module: block-level implementations of the dataflow operators
(paper §3.6). Narrow ops here; wide (shuffle-backed) ops in shuffle.py.

User functions are torch row functions, vectorised over the block with
``torch.func.vmap``. A boolean mask carries filter results (fixed shapes —
no dynamic compaction on device).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import vmap

from repro_torch.core import tree
from repro_torch.core.partition import Block

# python scalars a row fn returns become tensors of the reference's 32-bit
# dtypes (the JAX package runs without 64-bit mode)
_SCALAR_DTYPES = ((bool, torch.bool), (int, torch.int32), (float, torch.float32))


def _as_leaf(o, device):
    if isinstance(o, torch.Tensor):
        return o
    for py, dt in _SCALAR_DTYPES:
        if isinstance(o, py):
            return torch.as_tensor(o, dtype=dt, device=device)
    return torch.as_tensor(o, device=device)


def _vmapped(fn: Callable) -> Callable:
    """``fn`` over every row of its tree arguments. Constant outputs (python
    scalars, unbatched tensors) broadcast to one value per row."""

    def one(*args):
        dev = tree.leaves(args)[0].device
        return tree.map(lambda o: _as_leaf(o, dev), fn(*args))

    def run(*args):
        out = vmap(one)(*args)
        return tree.map(lambda o: o.contiguous(), out)

    return run


# ---------------------------------------------------------------------------
# narrow ops
# ---------------------------------------------------------------------------


def map_block(b: Block, fn: Callable) -> Block:
    return Block(_vmapped(fn)(b.data), b.valid)


def map_partitions_block(b: Block, fn: Callable) -> Block:
    """fn operates on the whole block data (tensors with leading dim)."""
    return Block(fn(b.data), b.valid)


def filter_block(b: Block, pred: Callable) -> Block:
    keep = _vmapped(pred)(b.data)
    return Block(b.data, b.valid & keep.to(torch.bool))


def flatmap_block(b: Block, fn: Callable, fanout: int) -> Block:
    """fn: row → (tree with leading dim = fanout, valid_mask[fanout])."""
    outs, masks = _vmapped(fn)(b.data)  # leaves (N, F, …), masks (N, F)
    n = b.valid.shape[0]
    data = tree.map(lambda x: x.reshape(n * fanout, *x.shape[2:]), outs)
    valid = (masks.to(torch.bool) & b.valid[:, None]).reshape(n * fanout)
    return Block(data, valid)


def key_by_block(b: Block, fn: Callable) -> Block:
    keys = _vmapped(fn)(b.data)
    return Block({"key": keys, "value": b.data}, b.valid)


def map_values_block(b: Block, fn: Callable) -> Block:
    return Block(
        {"key": b.data["key"], "value": _vmapped(fn)(b.data["value"])}, b.valid
    )


def keys_block(b: Block) -> Block:
    return Block(b.data["key"], b.valid)


def values_block(b: Block) -> Block:
    return Block(b.data["value"], b.valid)


def sample_block(b: Block, frac: float, seed: int) -> Block:
    """Bernoulli(frac) row sample from an explicit generator seeded as the
    reference seeds its PRNG key (``seed + 13·capacity``). The bits differ
    from JAX's; the distribution does not."""
    g = torch.Generator(device=b.device)
    g.manual_seed(seed + 13 * b.capacity)
    u = torch.rand((b.capacity,), generator=g, device=b.device)
    return Block(b.data, b.valid & (u < frac))


# ---------------------------------------------------------------------------
# fusable kernels: Block → Block closures over one narrow op — the unit the
# DAG planner composes into FusedStages. mapPartitions is deliberately
# absent — its user fn takes raw block data and may do host-side work.
# ---------------------------------------------------------------------------


def map_kernel(fn: Callable) -> Callable:
    return lambda b: map_block(b, fn)


def filter_kernel(pred: Callable) -> Callable:
    return lambda b: filter_block(b, pred)


def flatmap_kernel(fn: Callable, fanout: int) -> Callable:
    return lambda b: flatmap_block(b, fn, fanout)


def key_by_kernel(fn: Callable) -> Callable:
    return lambda b: key_by_block(b, fn)


def map_values_kernel(fn: Callable) -> Callable:
    return lambda b: map_values_block(b, fn)


def sample_kernel(frac: float, seed: int) -> Callable:
    return lambda b: sample_block(b, frac, seed)


# ---------------------------------------------------------------------------
# reductions (log-depth pairwise fold, general binary fn)
# ---------------------------------------------------------------------------


def pairwise_reduce(data, valid, fn, identity):
    """Reduce rows with an associative vectorised binary fn in log depth.
    ``identity`` is a row tree substituted for masked-out rows."""
    n = tree.leaves(data)[0].shape[0]
    m = 1
    while m < n:
        m *= 2

    def prep(x, i):
        i = torch.as_tensor(i, dtype=x.dtype, device=x.device)
        x = torch.where(valid.reshape((-1,) + (1,) * (x.ndim - 1)), x, i)
        if m > n:
            x = torch.cat([x, i.expand((m - n, *x.shape[1:]))], dim=0)
        return x

    data = tree.map(prep, data, identity)
    k = m
    while k > 1:
        k //= 2
        lo = tree.map(lambda x: x[:k], data)
        hi = tree.map(lambda x: x[k: 2 * k], data)
        data = fn(lo, hi)
    return tree.map(lambda x: x[0], data)


def count_block(b: Block):
    return b.valid.sum(dtype=torch.int32)

