"""Row trees: the dict/tuple/list containers the dataflow layer nests its
tensors in (``{"key": k, "value": v}``, ``(a, b)``, …).

The small subset of pytree handling the port needs — ``leaves``,
``flatten``/``unflatten`` and ``map`` — over dicts (keys visited in sorted
order, as the JAX package's trees are), tuples and lists. Everything else is
a leaf. A treedef is a nested tuple, so it is hashable and can key a plan
cache.
"""
from __future__ import annotations

from typing import Any, Callable

_LEAF = "*"


def _is_node(x) -> bool:
    return isinstance(x, (dict, tuple, list))


def flatten(tree) -> tuple[list, Any]:
    """``(leaves, treedef)`` with leaves in a fixed visiting order."""
    out: list = []
    return out, _flatten(tree, out)


# module-level recursion: a nested recursive function would be a reference
# cycle (the function and its closure cell) holding the leaves until the
# cyclic garbage collector runs, which keeps device memory alive
def _flatten(x, out: list):
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        return ("dict", keys, tuple(_flatten(x[k], out) for k in keys))
    if isinstance(x, (tuple, list)):
        kind = "tuple" if isinstance(x, tuple) else "list"
        return (kind, len(x), tuple(_flatten(v, out) for v in x))
    out.append(x)
    return _LEAF


def unflatten(treedef, leaves) -> Any:
    return _unflatten(treedef, iter(leaves))


def _unflatten(d, it):
    if d == _LEAF:
        return next(it)
    kind, meta, children = d
    if kind == "dict":
        return {k: _unflatten(c, it) for k, c in zip(meta, children)}
    vals = [_unflatten(c, it) for c in children]
    return tuple(vals) if kind == "tuple" else vals


def leaves(tree) -> list:
    return flatten(tree)[0]


def map(fn: Callable, tree, *rest):  # noqa: A001 — mirrors jax.tree.map
    """Apply ``fn`` leafwise across ``tree`` and same-shaped ``rest``."""
    ls, treedef = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    for o in others:
        if len(o) != len(ls):
            raise ValueError("tree.map: trees have different structure")
    return unflatten(treedef, [fn(*xs) for xs in zip(ls, *others)])
