"""Carrying blocks and model weights across from the JAX package and back.

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


def _tensor(a) -> torch.Tensor:
    """A numpy leaf as a tensor, bit for bit. A JAX bf16 array taken to
    numpy has ``ml_dtypes``' bfloat16 type, which ``torch.from_numpy``
    refuses: it crosses as uint16 and is viewed back as bfloat16."""
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_reference(params_np, cfg, device="cpu"):
    """The port's model of ``cfg``'s family (``TransformerLM`` for dense and
    MoE, ``SSMLM`` for SSM) holding the JAX package's weights.

    ``params_np`` is the JAX parameter tree of ``cfg`` with its leaves taken
    to numpy (layers stacked on axis 0). Every leaf lands in the parameter
    of the same path (``layers.<i>.attn.wq`` ← ``layers/attn/wq[i]``,
    ``layers.<i>.ffn.router`` ← ``layers/ffn/router[i]``,
    ``layers.<i>.mixer.A_log`` ← ``layers/mixer/A_log[i]``), with its shape
    and dtype checked; every leaf must be used."""
    from repro_torch.models.model_zoo import build_module

    lm = build_module(cfg, device=device)
    used = set()
    with torch.no_grad():
        for name, p in lm.named_parameters():
            path = name.split(".")
            index = None
            if path[0] == "layers":
                index, path = int(path[1]), ["layers", *path[2:]]
            leaf = params_np
            for part in path:
                leaf = leaf[part]
            used.add(tuple(path))
            t = _tensor(leaf if index is None else np.asarray(leaf)[index])
            if t.shape != p.shape or t.dtype != p.dtype:
                raise ValueError(f"{name}: reference leaf {tuple(t.shape)} {t.dtype} "
                                 f"does not fit {tuple(p.shape)} {p.dtype}")
            p.copy_(t)
    leaves = set()

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, (*path, k))
        else:
            leaves.add(path)

    walk(params_np, ())
    if leaves != used:
        raise ValueError(f"reference leaves without a parameter: {sorted(leaves - used)}")
    return lm
