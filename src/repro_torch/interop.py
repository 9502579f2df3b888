"""Carrying blocks, model weights and optimizer state across from the JAX
package and back.

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


def leaf_of(name: str):
    """``(path, row)`` of the reference leaf that parameter ``name`` is part
    of: a JAX leaf stacks the layers (or the hybrid's blocks, or each side
    of the encoder-decoder), so ``layers.<i>.attn.wq`` is row ``i`` of
    ``("layers", "attn", "wq")``, ``blocks.<b>.s3.mixer.A_log`` row ``b``
    of ``("blocks", "s3", "mixer", "A_log")``, and ``enc_layers.<i>.…`` and
    ``dec_layers.<i>.…`` likewise; any other name is a whole leaf (row
    ``None``)."""
    path = name.split(".")
    if len(path) > 2 and path[1].isdigit():  # an nn.ModuleList's entry
        return (path[0], *path[2:]), int(path[1])
    return tuple(path), None


def _leaf_at(tree, name: str):
    """``(path, leaf)`` of the reference tree that parameter ``name`` reads
    (``leaf_of``)."""
    path, index = leaf_of(name)
    leaf = tree
    for part in path:
        leaf = leaf[part]
    if index is not None:
        leaf = leaf[index]
    return path, leaf if isinstance(leaf, torch.Tensor) else _tensor(leaf)


def _leaf_paths(tree) -> set:
    out = set()

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, (*path, k))
        else:
            out.add(path)

    walk(tree, ())
    return out


def load_reference(module, tree, values=None) -> None:
    """Copy a reference-layout tree (numpy or tensor leaves, layers stacked
    on axis 0) into ``module``'s parameters, or into ``values`` (``{name:
    tensor}`` keyed as ``module.named_parameters()``, e.g. an optimizer
    moment) when given. Shapes and dtypes are checked; every leaf must be
    used."""
    used = set()
    with torch.no_grad():
        for name, p in module.named_parameters():
            dst = p if values is None else values[name]
            path, t = _leaf_at(tree, name)
            used.add(path)
            if t.shape != dst.shape or t.dtype != dst.dtype:
                raise ValueError(f"{name}: reference leaf {tuple(t.shape)} {t.dtype} "
                                 f"does not fit {tuple(dst.shape)} {dst.dtype}")
            dst.copy_(t)
    leaves = _leaf_paths(tree)
    if leaves != used:
        raise ValueError(f"reference leaves without a parameter: {sorted(leaves - used)}")


def params_from_reference(params_np, cfg, device="cpu"):
    """The port's model of ``cfg``'s family (``TransformerLM`` for dense,
    MoE and VLM, ``SSMLM`` for SSM, ``HybridLM``, ``EncDecLM``) holding the
    JAX package's weights.

    ``params_np`` is the JAX parameter tree of ``cfg`` with its leaves taken
    to numpy (layers stacked on axis 0). Every leaf lands in the parameter
    of the same path (``layers.<i>.attn.wq`` ← ``layers/attn/wq[i]``,
    ``blocks.<b>.attn.attn.wq`` ← ``blocks/attn/attn/wq[b]``,
    ``dec_layers.<i>.cross_attn.wk`` ← ``dec_layers/cross_attn/wk[i]``;
    ``interop.leaf_of``), with its shape and dtype checked; every leaf must
    be used."""
    from repro_torch.models.model_zoo import build_module

    lm = build_module(cfg, device=device)
    load_reference(lm, params_np)
    return lm


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def reference_tree(module, values=None, leaf=lambda t: t.detach().cpu()):
    """``module``'s parameters (or ``values``, keyed as
    ``module.named_parameters()``) in the JAX package's tree: nested dicts
    by module path, a parameterless module (olmo's LayerNorm) as ``{}``, and
    the ``layers`` list stacked on a leading axis. Each tensor passes
    through ``leaf`` first (by default a host copy; ``lambda t:
    t.to("meta")`` gives shapes alone, e.g. a restore target)."""
    def go(mod, prefix):
        out = {n: leaf(p if values is None else values[prefix + n])
               for n, p in mod.named_parameters(recurse=False)}
        for n, child in mod.named_children():
            if isinstance(child, torch.nn.ModuleList):
                out[n] = _stack([go(c, f"{prefix}{n}.{i}.") for i, c in enumerate(child)])
            else:
                out[n] = go(child, f"{prefix}{n}.")
        return out

    return go(module, "")


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy; bf16 as ``ml_dtypes``' bfloat16 (the numpy
    type a JAX bf16 array has), which the caller must have installed."""
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _tree_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_numpy(v) for k, v in tree.items()}
    return _numpy(tree)


def params_to_reference(module, cfg):
    """The JAX parameter tree of ``cfg`` as numpy from the port's ``module``
    (the inverse of ``params_from_reference``): ``jax.tree.map(jnp.asarray,
    ·)`` of it is what the JAX package's functions take."""
    from repro_torch.models.model_zoo import build_module

    want = build_module(cfg, device="meta")
    for name, child in module.named_children():
        if isinstance(child, torch.nn.ModuleList) and len(child) != len(getattr(want, name)):
            raise ValueError(f"{cfg.name}: {len(child)} {name}, the config has "
                             f"{len(getattr(want, name))}")
    return _tree_numpy(reference_tree(module))


def opt_tree(module, opt, leaf=lambda t: t.detach().cpu()):
    """The port's optimizer state (``optim.init_opt_state``'s) in the JAX
    package's tree: ``m`` and ``v`` shaped as ``module``'s parameters'
    tree (``reference_tree``), ``step`` the 0-d int32 counter; each tensor
    passes through ``leaf``."""
    return {"m": reference_tree(module, opt["m"], leaf),
            "v": reference_tree(module, opt["v"], leaf),
            "step": leaf(opt["step"])}


def opt_to_reference(opt, module):
    """``opt_tree`` as numpy: the JAX package's optimizer state."""
    return _tree_numpy(opt_tree(module, opt))


def opt_from_reference(opt_np, module):
    """The JAX package's optimizer state (numpy or tensor leaves) as the
    port's for ``module``, on the module's device, moments in the tree's
    dtype."""
    from repro_torch.optim.adamw import init_opt_state

    _, m0 = _leaf_at(opt_np["m"], next(n for n, _ in module.named_parameters()))
    opt = init_opt_state(module, m0.dtype)
    load_reference(module, opt_np["m"], opt["m"])
    load_reference(module, opt_np["v"], opt["v"])
    step = opt_np["step"]
    step = step if isinstance(step, torch.Tensor) else _tensor(step)
    opt["step"] = step.to(device=opt["step"].device, dtype=torch.int32).reshape(())
    return opt
