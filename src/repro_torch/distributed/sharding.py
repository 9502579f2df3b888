"""Sharding rules: map every param / input / cache leaf to a PartitionSpec
(the port of ``repro.distributed.sharding``).

Name-based logical-axis rules: a leaf's dict path and rank decide its spec,
as pure functions of (leaf path, shape, cfg, mesh axis sizes). The trees
are the JAX package's: ``param_specs`` takes the port's parameters and
reads their leaf names from ``interop.reference_tree`` (``layers/…``
stacked, the hybrid's ``blocks/…``, the encoder-decoder's
``enc_layers/…``/``dec_layers/…``), and ``opt_specs`` the optimizer state
in that tree (``interop.opt_tree``).

Presets
  dp       — weights & optimizer replicated; batch over ("pod","data").
  fsdp     — weight rows (d_model) sharded over "data".
  fsdp_tp  — rows over "data" (FSDP), columns (heads / d_ff / vocab) over
             "model" (TP).
  tp       — columns over "model" only.
  *_zero1  — suffix: optimizer moments sharded over "data" even when the
             params are replicated (ZeRO-1).

Decode caches shard batch over ("pod","data") and heads/head_dim over
"model"; a batch too small for the batch axes context-shards the KV
sequence axis over "data" instead.

``to_named`` turns specs into ``Placement``s over the mesh's virtual ranks:
which rank holds which slice of each leaf, and how many bytes each rank
holds. On one card this is bookkeeping: every rank's slice lives in the
one tensor on the mesh's device, and the arithmetic does not change.
"""
from __future__ import annotations

import math

import torch

# leaf names whose matrices map (…, d_model, X): rows=fsdp(data), cols=tp(model)
_OUT_LAST = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj", "w1", "router", "vit_proj"}
# leaf names whose matrices map (…, X, d_model): rows=tp(model), cols=fsdp(data)
_IN_FIRST = {"wo", "w_down", "out_proj", "w2"}


class PartitionSpec(tuple):
    """One mesh-axis entry per leading dimension of a leaf: an axis name, a
    tuple of names (the dimension split over their product, the first
    name major), or None (not split). Entries normalise as JAX's
    ``PartitionSpec`` does: ``("data",)`` is ``"data"`` and ``()`` is
    ``None``; trailing Nones count (``P()`` is not ``P(None)``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(_entry(p) for p in parts))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _entry(p):
    if isinstance(p, (tuple, list)):
        p = tuple(p)
        if not p:
            return None
        return p[0] if len(p) == 1 else p
    return p


# ---------------------------------------------------------------------------
# trees: nested dicts / lists / tuples; a PartitionSpec is a leaf
# ---------------------------------------------------------------------------


class _Index(int):
    """A sequence position in a leaf's path (not a name)."""


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple)) and not isinstance(x, PartitionSpec)


def _map_with_path(fn, tree, path=()):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, (*path, k)) for k, v in tree.items()}
    if _is_node(tree):
        out = [_map_with_path(fn, v, (*path, _Index(i))) for i, v in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(path, tree)


def _map2(fn, a, b):
    """``fn(leaf of a, leaf of b)`` over two trees of one structure."""
    if a is None:
        return None
    if isinstance(a, dict):
        if set(a) != set(b):
            raise ValueError(f"tree keys differ: {sorted(a)} against {sorted(b)}")
        return {k: _map2(fn, a[k], b[k]) for k in a}
    if _is_node(a):
        if len(a) != len(b):
            raise ValueError(f"tree lengths differ: {len(a)} against {len(b)}")
        out = [_map2(fn, x, y) for x, y in zip(a, b)]
        return tuple(out) if isinstance(a, tuple) else out
    return fn(a, b)


def _leaf_name(path) -> str:
    for k in reversed(path):
        if not isinstance(k, _Index):
            return str(k)
    return ""


def param_tree(params):
    """The reference tree of the port's parameters (a module: shapes alone,
    on ``meta``), or ``params`` when it already is one."""
    if isinstance(params, torch.nn.Module):
        from repro_torch.interop import reference_tree

        return reference_tree(params, leaf=lambda t: t.to("meta"))
    return params


# ---------------------------------------------------------------------------
# mesh axes
# ---------------------------------------------------------------------------


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axsize(mesh, name) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _div(mesh, axis_name, dim) -> bool:
    return dim % _axsize(mesh, axis_name) == 0


def lead_axes(cfg, mesh, B: int, kind: str = "train") -> tuple:
    """Mesh axes the batch dim shards over: the largest divisible candidate.

    The dp preset has no TP, so the model axis is free to absorb batch (pure
    data parallelism over every rank); fsdp_tp reserves "model" for TP.
    """
    names = mesh.axis_names
    if cfg.sharding_preset.startswith("dp"):
        cands = [
            tuple(names),
            tuple(a for a in ("data", "model") if a in names),
            batch_axes(mesh),
            ("data",) if "data" in names else (),
        ]
    else:
        cands = [batch_axes(mesh), ("data",) if "data" in names else ()]
    for c in cands:
        n = 1
        for a in c:
            n *= _axsize(mesh, a)
        if c and B % n == 0 and B >= n:
            return c
    return ()


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def _param_spec_one(path, aval, cfg, mesh) -> P:
    preset = cfg.sharding_preset.replace("_zero1", "")
    if preset == "dp":
        return P()
    fsdp_rows = preset in ("fsdp", "fsdp_tp")  # "tp": cols only (+ZeRO-1)
    name = _leaf_name(path)
    rank = len(aval.shape)
    if name == "embed" and rank == 2:
        v, d = aval.shape
        return P("model" if _div(mesh, "model", v) else None,
                 "data" if (fsdp_rows and _div(mesh, "data", d)) else None)
    if name == "lm_head" and rank == 2:
        d, v = aval.shape
        return P("data" if (fsdp_rows and _div(mesh, "data", d)) else None,
                 "model" if _div(mesh, "model", v) else None)
    # sequence-parallel attention: S carries the model axis through the
    # attention block, so its projections must NOT column-shard over "model"
    attn_mats = {"wq", "wk", "wv", "wo"}
    sp = getattr(cfg, "attn_sp", False)
    # expert parallelism: stacked expert mats (L, E, D, F) shard E over
    # "data" (EP) and columns over "model" (TP)
    if rank == 4 and name in ("w_gate", "w_up", "w_down") and _div(
        mesh, "data", aval.shape[1]
    ):
        if name == "w_down":  # (L, E, F, D)
            row = "model" if _div(mesh, "model", aval.shape[2]) else None
            return P(None, "data", row, None)
        col = "model" if _div(mesh, "model", aval.shape[3]) else None
        return P(None, "data", None, col)
    if rank >= 2 and name in _OUT_LAST:
        r, c = aval.shape[-2], aval.shape[-1]
        row = "data" if (fsdp_rows and _div(mesh, "data", r)) else None
        col = "model" if (name != "router" and _div(mesh, "model", c)) else None
        if sp and name in attn_mats:
            col = None
        return P(*((None,) * (rank - 2)), row, col)
    if rank >= 2 and name in _IN_FIRST:
        r, c = aval.shape[-2], aval.shape[-1]
        row = "model" if _div(mesh, "model", r) else None
        col = "data" if (fsdp_rows and _div(mesh, "data", c)) else None
        if sp and name in attn_mats:
            row = None
        return P(*((None,) * (rank - 2)), row, col)
    if name == "conv_w" and rank >= 2 and _div(mesh, "model", aval.shape[-1]):
        return P(*((None,) * (rank - 1)), "model")
    return P()  # norms, biases, scalars, pos tables


def param_specs(params, cfg, mesh):
    """PartitionSpec tree in the JAX package's parameter tree: ``params``
    is the port's model (its leaves named by ``interop.reference_tree``) or
    such a tree (tensors, or anything with a ``shape``)."""
    return _map_with_path(lambda path, leaf: _param_spec_one(path, leaf, cfg, mesh),
                          param_tree(params))


def opt_specs(opt_tree, params_spec_tree, cfg, mesh):
    """Optimizer state specs (``opt_tree`` as ``interop.opt_tree`` gives
    it): moments mirror params, or ZeRO-1-shard them."""
    zero1 = cfg.sharding_preset.endswith("_zero1")

    def moment(spec, leaf):
        if not zero1:
            return spec
        # ZeRO-1: shard the first divisible dim over "data" if not already
        if any(s in ("data", ("data",)) for s in spec):
            return spec
        parts = list(spec) + [None] * (len(leaf.shape) - len(spec))
        for i, d in enumerate(leaf.shape):
            if parts[i] is None and _div(mesh, "data", d) and d > 1:
                parts[i] = "data"
                break
        return P(*parts)

    return {
        "m": _map2(moment, params_spec_tree, opt_tree["m"]),
        "v": _map2(moment, params_spec_tree, opt_tree["v"]),
        "step": P(),
    }


# ---------------------------------------------------------------------------
# inputs / caches
# ---------------------------------------------------------------------------


def input_specs_sharding(inputs, cfg, mesh, kind: str = "train"):
    """Specs for a batch dict (tokens/labels/frames/patches or decode args)."""

    def one(path, leaf):
        name = _leaf_name(path)
        if name in ("cache",):  # handled by cache_specs
            return P()
        B = leaf.shape[0] if len(leaf.shape) else 1
        lead = lead_axes(cfg, mesh, B, kind)
        return P(lead, *((None,) * (len(leaf.shape) - 1))) if len(leaf.shape) else P()

    out = {}
    for k, v in inputs.items():
        if k == "cache":
            out[k] = cache_specs(v, cfg, mesh)
        else:
            out[k] = _map_with_path(one, v)
    return out


def cache_specs(cache_tree, cfg, mesh):
    """Decode-cache specs (see module docstring)."""

    def _lead(B):
        return lead_axes(cfg, mesh, B, "decode")

    def one(path, leaf):
        name = _leaf_name(path)
        shape = tuple(leaf.shape)
        if name in ("k", "v", "k_cross", "v_cross") and len(shape) == 5:
            L, B, S, K, hd = shape
            bl = _lead(B)
            if bl:
                bspec, sspec = bl, None
            else:
                bspec, sspec = None, ("data" if _div(mesh, "data", S) else None)
            model_used = "model" in bl
            if not model_used and _div(mesh, "model", K):
                kspec, hspec = "model", None
            elif not model_used and _div(mesh, "model", hd):
                kspec, hspec = None, "model"
            else:
                kspec = hspec = None
            return P(None, bspec, sspec, kspec, hspec)
        if name == "state" and len(shape) >= 5:
            # (..., B, H, P, N)
            parts = [None] * len(shape)
            B, H = shape[-4], shape[-3]
            bl = _lead(B)
            if bl:
                parts[-4] = bl
            if "model" not in bl and _div(mesh, "model", H):
                parts[-3] = "model"
            return P(*parts)
        if name == "conv" and len(shape) >= 4:
            # (..., B, w, ch)
            parts = [None] * len(shape)
            B, ch = shape[-3], shape[-1]
            bl = _lead(B)
            if bl:
                parts[-3] = bl
            if "model" not in bl and _div(mesh, "model", ch):
                parts[-1] = "model"
            return P(*parts)
        if len(shape) == 1:  # pos, enc_len
            bl = _lead(shape[0])
            return P(bl) if bl else P()
        return P()

    return _map_with_path(one, cache_tree)


# ---------------------------------------------------------------------------
# placement over the mesh's ranks
# ---------------------------------------------------------------------------


class Placement:
    """Where one leaf of ``shape`` lives on ``mesh``'s ranks under
    ``spec``: dimension ``i`` is cut into as many equal pieces as its
    entry's axes have ranks (row-major over the entry's axes), and rank
    ``r`` holds the piece its coordinates pick in every dimension
    (``index``). Ranks that differ only on axes the spec does not name hold
    the same piece."""

    def __init__(self, mesh, spec: P, shape, itemsize: int):
        spec = spec if isinstance(spec, PartitionSpec) else P(*spec)
        shape = tuple(int(s) for s in shape)
        if len(spec) > len(shape):
            raise ValueError(f"spec {spec} has more entries than shape {shape} has dims")
        used = [a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e)]
        for a in used:
            if a not in mesh.shape:
                raise ValueError(f"spec {spec} names {a!r}, which mesh axes "
                                 f"{mesh.axis_names} do not have")
        if len(set(used)) != len(used):
            raise ValueError(f"spec {spec} names an axis twice")
        self.mesh, self.spec, self.shape, self.itemsize = mesh, spec, shape, int(itemsize)
        self.pieces = tuple(self._axes_size(spec[i] if i < len(spec) else None)
                            for i in range(len(shape)))
        for d, k in zip(shape, self.pieces):
            if d % k:
                raise ValueError(f"spec {spec} cuts a dim of {d} into {k} pieces: "
                                 f"shape {shape} does not divide")

    def _axes_size(self, entry) -> int:
        if entry is None:
            return 1
        axes = (entry,) if isinstance(entry, str) else entry
        return math.prod(self.mesh.shape[a] for a in axes)

    def index(self, rank: int) -> tuple:
        """The ``(start, stop)`` of each dimension that ``rank`` holds."""
        coords = self.mesh.coords(rank)
        out = []
        for i, (d, k) in enumerate(zip(self.shape, self.pieces)):
            entry = self.spec[i] if i < len(self.spec) else None
            j = 0
            if entry is not None:
                for a in ((entry,) if isinstance(entry, str) else entry):
                    j = j * self.mesh.shape[a] + coords[a]
            n = d // k
            out.append((j * n, (j + 1) * n))
        return tuple(out)

    @property
    def rank_bytes(self) -> int:
        """The bytes every rank holds of this leaf."""
        return math.prod(self.shape) // math.prod(self.pieces) * self.itemsize

    def __repr__(self):
        return f"Placement({self.spec}, {self.shape}, {self.rank_bytes} B a rank)"


def _itemsize(leaf) -> int:
    dt = leaf.dtype
    return dt.itemsize if isinstance(dt, torch.dtype) else int(getattr(dt, "itemsize", 1))


def to_named(tree_of_specs, mesh, like):
    """A ``Placement`` per leaf: ``tree_of_specs`` over ``mesh`` for the
    leaves of ``like`` (the tree the specs were made from)."""
    return _map2(lambda s, leaf: Placement(mesh, s, leaf.shape, _itemsize(leaf)),
                 tree_of_specs, like)


def rank_bytes(placements) -> int:
    """The bytes each rank holds of a tree of placements (every rank holds
    one piece of every leaf, so this is the same for all ranks)."""
    from repro_torch.core import tree

    return sum(p.rank_bytes for p in tree.leaves(placements))
