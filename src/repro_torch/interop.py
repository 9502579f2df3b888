"""Carrying blocks across from the JAX package and back.

For a dataflow system the blocks are the state. A JAX block row-sharded
over ``p`` devices holds rows ``[r·N/p, (r+1)·N/p)`` on device ``r``; taken
to numpy, its leaves list those rows in rank order — which is exactly the
port's flat rank-major layout. So the two functions below only change the
container, never the order of rows, and a capacity-padded block (padding
rows, positions and all) compares leaf for leaf after a wide stage.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import tree
from repro_torch.core.partition import Block


def block_from_reference(data_tree_np, valid_np, p: int, device="cpu") -> Block:
    """A port Block from a JAX block's leaves, taken to numpy in row order."""
    valid = np.asarray(valid_np)
    if valid.shape[0] % p:
        raise ValueError(f"{valid.shape[0]} rows do not split over {p} ranks")
    data = tree.map(lambda x: torch.from_numpy(np.array(x)).to(device), data_tree_np)
    return Block(data, torch.from_numpy(valid.astype(bool)).to(device))


def block_to_numpy(block: Block):
    """``(data tree of numpy arrays, valid numpy bool array)`` in row order."""
    data = tree.map(lambda x: x.detach().cpu().numpy(), block.data)
    return data, block.valid.detach().cpu().numpy()
