"""The dry run (the port of ``repro.launch.dryrun``): what one cell of the
production run — an architecture, a shape cell, the 256-rank pod mesh or
the 512-rank two-pod one — costs each rank, without running it.

  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--single-pod-only] [--retry-failed]
  (add --device cpu on a host without a card)

The JAX dry run lowers and compiles the step for the mesh and reads XLA's
memory and cost analysis. Torch has no SPMD partitioner, so nothing here is
lowered or compiled: the step is traced on fake tensors (the bundle's
``step_for_cell``: shapes, dtypes and a device, no storage) and each rank's
share is modelled from the sharding specs. The record keeps the JAX
record's keys, so one reader serves both files: ``chips`` is the mesh's
rank count, ``xla_cost`` becomes ``graph_cost`` (the traced step's global
FLOPs and bytes), ``lower_s`` is the tracing time and ``compile_s`` 0.

Pricing. The layers are a Python loop, so a traced 40-layer step at 32k
tokens unrolls into hundreds of thousands of nodes. Instead each distinct
layer signature is priced once and multiplied by its count, the port's
counterpart of ``hlo_cost``'s trip-count multiply of ``while`` bodies. A
signature is a layer list's name and, for the transformer, the layer's
window (gemma3's local and global layers); a hybrid block (its attention
slot, dense and MoE mamba slots) and an encoder or decoder layer are one
each. The step is traced on the model with its layer lists emptied (the
base: embedding, head, loss, the caches, the optimizer on those weights)
and on the model holding one layer of each signature; a signature's cost is
the difference, so the step prices as base + sum of count x difference. No
op crosses layers (each layer writes its own slot of a stacked cache), so
this equals tracing the unrolled step. Inside a trace the plain attention's
query-chunk loop is traced once and priced per chunk
(``profile.cost.repeated``). The train step traces the forward, autograd's
backward and the AdamW update; under ``remat="full"`` the layer's
checkpoint replays its forward inside the backward, so the recompute is in
the priced graph, as it is in JAX's HLO.

Per rank. FLOPs and HBM bytes come from the global graph: the forward and
backward are divided by the ranks that split the batch (``lead_axes``)
times the tensor-parallel ranks (the ``model`` axis when a weight is split
over it and the batch is not), the optimizer update by the ratio of the
moments' global bytes to their bytes a rank (the specs' split of the
moments); replicated work counts on every rank, as a partitioned program
runs it.

Memory (``memory``, bytes a rank): ``argument_size_in_bytes`` is the sum
of the arguments' ``rank_bytes`` under the specs (exact);
``output_size_in_bytes`` the outputs' under the same specs (the logits
split as the batch, the cache by ``cache_specs``, the train step's params,
optimizer state and f32 loss); ``alias_size_in_bytes`` the donated
arguments (JAX's ``donate``: params and optimizer state in train, the cache
in decode); ``temp_size_in_bytes`` the peak of live intermediates
(``profile.cost.memory_walk``: the largest of the priced graphs' peaks and,
in train, each further layer's activations kept for the backward — the
live bytes after the loss, layer graph minus base), divided by the batch
ranks; ``generated_code_size_in_bytes`` 0.

Collectives come from the specs, not a graph: FSDP's all-gather of every
weight split over ``data`` (per pass: once in prefill and decode, in train
forward and backward), the gradients' reduce-scatter over the batch axes
that split the weight and all-reduce over the rest, tensor parallelism's
all-reduce of the activations after each product whose input dimension is
split over ``model`` (and after an embedding split over the vocabulary;
train adds the backward's and, under ``remat="full"``, the recompute's),
and expert parallelism's two all-to-alls a MoE layer under ``moe_ep``. The
bytes on the wire a rank follow ``launch/hlo_cost.py``: all-reduce
2(n-1)/n·b, all-gather, reduce-scatter and all-to-all (n-1)/n·b, b the
full (gathered) size. Not modelled: the vocabulary-parallel loss's
reductions and the context-sharded decode's partial softmax (a few bytes a
token).

Roofline: the same fields and formulas as the JAX record, with the H100
SXM data sheet's rates (below) in place of the TPU's.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import functools
import json
import math
import os
import pathlib
import subprocess
import sys
import time
import traceback
from collections import Counter

import torch

# NVIDIA H100 SXM5 data sheet (the card the port runs on): dense BF16
# tensor-core rate, HBM3 bandwidth, NVLink 4 (900 GB/s both directions, so
# 450 GB/s each way) within a node of 8, and one 400 Gb/s NIC a GPU across
# nodes.
PEAK_FLOPS = 989e12  # bf16 FLOP/s a card
HBM_BW = 3.35e12  # bytes/s a card
NVLINK_BW = 450e9  # bytes/s a direction, within a node
NET_BW = 50e9  # bytes/s a direction, across nodes
NODE_CARDS = 8  # cards a node: mesh ranks r and r' share one when r // 8 == r' // 8

DEFAULT_JSONL = str(pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"
                    / "dryrun.jsonl")

#: each family's layer lists (attributes of its module)
_LISTS = {"dense": ("layers",), "moe": ("layers",), "vlm": ("layers",), "ssm": ("layers",),
          "hybrid": ("blocks",), "audio": ("enc_layers", "dec_layers")}


def cell_key(arch, shape, multi_pod, tag=""):
    base = f"{arch}|{shape}|{'multi' if multi_pod else 'single'}"
    return f"{base}|{tag}" if tag else base


def _parse_override(s: str):
    k, _, v = s.partition("=")
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    if v in ("True", "False"):
        return k, v == "True"
    if v == "None":
        return k, None
    return k, v


# ---------------------------------------------------------------------------
# pricing: the base and one layer of each signature
# ---------------------------------------------------------------------------

#: priced pieces, by (config, cell shape, device, signature): a multi-pod
#: cell prices the same global graphs as its single-pod one
_PIECES: dict = {}
#: each cell's bundle, abstract arguments and their reference trees
_CELLS: dict = {}


def _units(params, family):
    """``[(unit id, signature)]`` of the model's layers in order. A unit id
    is ``(list, index)``, or ``("blocks", block, slot)`` for the hybrid,
    whose unit is a slot (``"attn"``, ``"s1"`` … ``"s7"``) of a block."""
    from repro_torch.models.moe import MoE

    out = []
    for name in _LISTS[family]:
        for i, unit in enumerate(getattr(params, name)):
            if family != "hybrid":
                out.append(((name, i), (name, getattr(unit, "window", None))))
                continue
            out.append(((name, i, "attn"), (name, "attn")))
            for sp in unit.slots():
                kind = "moe" if isinstance(sp.ffn, MoE) else "mlp"
                out.append(((name, i, f"s{sp.index}"), (name, kind)))
    return out


def plan(cfg, params):
    """The pieces that price ``params``'s step: ``(counts, floor,
    pieces)``, where ``counts`` is each signature's layer count past the
    floor, ``floor`` the signatures every piece holds (an audio model keeps
    one decoder layer: the encoder's output reaches the loss only through
    a decoder layer's cross-attention) and ``pieces`` maps None (the base)
    and each signature to the unit ids its piece holds."""
    units = _units(params, cfg.family)
    by_sig, counts = {}, Counter()
    for uid, sig in units:
        by_sig.setdefault(sig, []).append(uid)
        counts[sig] += 1
    floor = Counter()
    if cfg.family == "audio":
        floor[("dec_layers", None)] = 1
    pieces = {None: tuple(uid for sig, n in floor.items() for uid in by_sig[sig][:n])}
    for sig in counts:
        if counts[sig] > floor[sig]:
            pieces[sig] = pieces[None] + (by_sig[sig][floor[sig]],)
    return {sig: n - floor[sig] for sig, n in counts.items()}, floor, pieces


class _BlockPart(torch.nn.Module):
    """Some slots of a hybrid block, which the block functions run as a
    block (``attn`` None when the attention slot is left out)."""

    def __init__(self, block, slots):
        super().__init__()
        for name, slot in block.named_children():  # in the block's order
            if name in slots:
                self.add_module(name, slot)
        if "attn" not in slots:
            self.attn = None

    def slots(self):
        return [m for n, m in self.named_children() if n != "attn"]

    def layers(self):
        return list(self.children())


def _with_units(params, family, uids):
    """``params`` holding only the layers ``uids`` names (their lists
    otherwise empty); the weights are the same tensors."""
    keep = {}
    for uid in uids:
        keep.setdefault(uid[0], {}).setdefault(uid[1], []).extend(uid[2:])
    m = copy.copy(params)
    m._modules = dict(params._modules)
    for name in _LISTS[family]:
        units = getattr(params, name)
        picked = keep.get(name, {})
        if family == "hybrid":
            kept = [_BlockPart(units[i], slots) for i, slots in picked.items()]
        else:
            kept = [units[i] for i in picked]
        m._modules[name] = torch.nn.ModuleList(kept)
    return m


def _marking(fn, name):
    from repro_torch.profile import cost

    def marked(*args):
        out = fn(*args)
        cost.mark(name)
        return out

    return marked


class _Shape:
    """A leaf's shape and dtype (what the specs and placements read)."""

    def __init__(self, t):
        self.shape, self.dtype = tuple(t.shape), t.dtype


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_shapes(v) for v in tree)
    return _Shape(tree)


def _price_piece(bundle, kind, params, uids, inputs, base=False):
    """Trace and price the cell's step on ``params`` holding the layers
    ``uids``: ``{"act", "opt"}`` CostEstimates (the optimizer update apart),
    the kernel calls by name, the live-memory walk, (for the base) the
    step's outputs' shapes, and the graph's code."""
    from repro_torch.profile import cost

    p = _with_units(params, bundle.cfg.family, uids)
    if kind == "train":
        pb = dataclasses.replace(bundle, train_loss=_marking(bundle.train_loss, "loss"))
        pb.value_and_grad = _marking(pb.value_and_grad, "grads")
        with bundle.fake_mode():
            opt = bundle.init_opt(p)
        fn, tensors = (lambda o, b: pb.train_step(p, o, b)[1:]), (opt, inputs)
    elif kind == "prefill":
        fn, tensors = (lambda i: bundle.prefill(p, **i)), (inputs,)
    else:
        fn, tensors = (lambda c, t: bundle.decode_step(p, c, t)), (inputs["cache"],
                                                                  inputs["tokens"])
    with cost.collapsing_loops():
        gm = cost.trace(fn, *tensors)
    model = cost.CostModel()
    if kind == "train":
        act, opt_est = model.price_parts(gm, "grads")
    else:
        act, opt_est = model.price_graph(gm), cost.CostEstimate()
    calls = Counter()
    for c in gm.meta["kernel_calls"]:
        calls[c.kernel] += c.count
    outputs = None
    if kind != "train" and base:  # the step's outputs, from the base's run
        with bundle.fake_mode():
            outputs = _shapes(fn(*tensors))
    return {"act": act, "opt": opt_est, "calls": calls, "walk": cost.memory_walk(gm),
            "outputs": outputs, "code": gm.code}


def _piece_key(cfg, cell, device, sig):
    return (cfg, cell.kind, cell.seq_len, cell.global_batch, str(device), sig)


def _cell_args(bundle, cell):
    """(params, inputs) of the cell's step, as fake tensors (no optimizer
    state: a train piece makes its own for the weights it holds)."""
    return bundle.abstract_params(), bundle.input_specs(cell)


def price_step(bundle, cell, params, inputs) -> dict:
    """The cell's step priced as the base plus each layer signature times
    its count (module docstring; pieces already priced by ``prefetch`` are
    reused). Returns the totals (``act``, ``opt`` CostEstimates, kernel
    ``calls``), the live intermediates' peak (``temp``), the signature
    counts and the base's output shapes."""
    cfg, kind = bundle.cfg, cell.kind
    counts, floor, pieces = plan(cfg, params)

    def piece(sig):
        k = _piece_key(cfg, cell, bundle.device, sig)
        if k not in _PIECES:
            _PIECES[k] = _price_piece(bundle, kind, params, pieces[sig], inputs,
                                      base=sig is None)
        return _PIECES[k]

    base = piece(None)
    act, opt, calls = base["act"], base["opt"], Counter(base["calls"])
    peaks = {None: base["walk"]["peak"]}
    saved, layer_calls = {}, {}
    for sig, n in counts.items():
        if not n:
            continue
        one = piece(sig)
        act = act + (one["act"] + base["act"].scaled(-1)).scaled(n)
        opt = opt + (one["opt"] + base["opt"].scaled(-1)).scaled(n)
        layer_calls[repr(sig)] = {k: c - base["calls"].get(k, 0) for k, c in one["calls"].items()}
        for name, c in layer_calls[repr(sig)].items():
            calls[name] += n * c
        peaks[sig] = one["walk"]["peak"]
        if kind == "train":
            saved[sig] = max(0, one["walk"]["marks"]["loss"] - base["walk"]["marks"]["loss"])
    if cfg.family == "hybrid" and kind == "train":
        # a block is one checkpoint: it keeps its input once for its eight
        # slots, so the attention slot's share stands for the block's
        saved = {sig: (v if sig[1] == "attn" else 0) for sig, v in saved.items()}
    top = max(peaks, key=peaks.get)
    temp = peaks[top] + sum((n - (sig == top)) * saved.get(sig, 0) for sig, n in counts.items())
    priced = [sig for sig, n in counts.items() if n]
    return {"act": act, "opt": opt, "calls": dict(calls), "layer_calls": layer_calls,
            "temp": temp,
            "signatures": {repr(sig): n + floor[sig] for sig, n in counts.items()},
            "outputs": base["outputs"], "graphs": 1 + len(priced),
            "codes": [base["code"], *(piece(sig)["code"] for sig in priced)]}


#: a worker's abstract cells, by job cell: its pieces share one model
_WORKER_CELLS: dict = {}
#: the seconds this worker's ``_warm_worker`` took
_WARM: dict = {}


def _warm_worker():
    """A worker's start: one thread (fake tensors compute nothing), and its
    first-use costs (lazy imports, fake-mode set-up) paid on a small step
    traced on fake tensors, before its first piece."""
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.models import build_model

    t0 = time.time()
    torch.set_num_threads(1)
    bundle = build_model(get_config("ignis-tiny").reduced(), device="cpu")
    params, inputs = _cell_args(bundle, ShapeCell("warm", 16, 2, "prefill"))
    _price_piece(bundle, "prefill", params, (), inputs)
    _WARM["seconds"] = time.time() - t0


def _prefetch_job(job):
    """One piece, priced in a worker process: ``job`` is (arch, overrides,
    cell, device, signature)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    t0 = time.time()
    arch, overrides, cell, device, sig = job
    cfg = get_config(arch).with_overrides(**overrides)
    k = (cfg, cell, device)
    if k not in _WORKER_CELLS:
        bundle = build_model(cfg, device=device)
        _WORKER_CELLS[k] = (bundle, *_cell_args(bundle, cell))
    bundle, params, inputs = _WORKER_CELLS[k]
    _, _, pieces = plan(cfg, params)
    res = _price_piece(bundle, cell.kind, params, pieces[sig], inputs, base=sig is None)
    res.update(seconds=time.time() - t0, worker=os.getpid(), warm_s=_WARM.get("seconds"))
    return _piece_key(cfg, cell, device, sig), res


def prefetch(cells, workers: int, device="cuda") -> dict:
    """Price the pieces of ``cells`` (``(arch, overrides, cell)`` triples)
    in ``workers`` processes at once, so that ``run_cell`` on them reuses
    them; the pieces of one cell go out together, the train cells' (the
    dearest) first. Returns ``pieces`` (the count priced), ``busy_s`` (the
    workers' seconds on pieces, summed), ``warm_s`` (a worker's start, the
    longest), ``dearest`` ((seconds, piece) of the longest piece)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_module

    def dearest_first(c):  # train pieces, the mamba mixers' and the audio ones most
        return c[2].kind != "train", get_config(c[0]).family not in ("hybrid", "ssm", "audio")

    jobs, seen = [], set()
    for arch, overrides, cell in sorted(cells, key=dearest_first):
        cfg = get_config(arch).with_overrides(**(overrides or {}))
        for sig in plan(cfg, build_module(cfg, "meta"))[2]:  # the plan reads structure only
            key = _piece_key(cfg, cell, device, sig)
            if key not in _PIECES and key not in seen:
                seen.add(key)
                jobs.append((arch, dict(overrides or {}), cell, str(device), sig))
    with ProcessPoolExecutor(max_workers=workers, mp_context=mp.get_context("spawn"),
                             initializer=_warm_worker) as ex:
        done = ex.map(_prefetch_job, jobs)
        for arch, overrides, cell in cells:  # the parent's share, meanwhile
            cfg = get_config(arch).with_overrides(**(overrides or {}))
            abstract_cell(cfg, cell, device)
            _active_params(cfg)
        stats = dict(pieces=len(jobs), busy_s=0.0, warm_s=0.0, dearest=(0.0, None))
        for key, res in done:
            _PIECES[key] = res
            stats["busy_s"] += res["seconds"]
            stats["warm_s"] = max(stats["warm_s"], res["warm_s"] or 0.0)
            label = f"{key[0].name} {key[1]} {key[-1]}"
            stats["dearest"] = max(stats["dearest"], (res["seconds"], label),
                                   key=lambda t: t[0])
    return stats


# ---------------------------------------------------------------------------
# specs, placements and collectives
# ---------------------------------------------------------------------------


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _spec_axes(spec) -> tuple:
    return tuple(a for e in spec for a in _axes(e))


def _group_rate(mesh, axes) -> float:
    """The wire rate of a collective over ``axes``: NVLink when its ranks
    (rank 0's group; ranks run row-major over the mesh) share a node."""
    import itertools

    ranges = [range(mesh.shape[a]) if a in axes else range(1) for a in mesh.axis_names]
    nodes = {mesh.rank_of(dict(zip(mesh.axis_names, c))) // NODE_CARDS
             for c in itertools.product(*ranges)}
    return NVLINK_BW if len(nodes) == 1 else NET_BW


def _wire(kind, n, b) -> float:
    if n <= 1:
        return 0.0
    return 2.0 * b * (n - 1) / n if kind == "all-reduce" else b * (n - 1) / n


def _leaves(tree, path=()):
    from repro_torch.distributed.sharding import PartitionSpec

    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*path, k))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        for i, v in enumerate(tree):
            yield from _leaves(v, (*path, i))
    else:
        yield path, tree


def _act_len(path, cfg, cell) -> int:
    """Tokens a sequence of the activations that the leaf at ``path`` acts
    on (the encoder's frames for an encoder leaf)."""
    from repro_torch.models.model_zoo import WHISPER_PREFILL_DEC, WHISPER_TRAIN_ENC

    if cell.kind == "decode":
        return 1
    if cfg.family == "audio":
        if path[0] == "enc_layers":
            return WHISPER_TRAIN_ENC if cell.kind == "train" else cell.seq_len
        return cell.seq_len if cell.kind == "train" else WHISPER_PREFILL_DEC
    return cell.seq_len


def collectives(cfg, cell, mesh, pspec, pplace) -> list:
    """The step's collectives a rank takes part in (module docstring), one
    entry per (kind, axes, leaf): its bytes each time (b, the full size),
    its count a step and its wire bytes."""
    from repro_torch.distributed.sharding import _IN_FIRST, lead_axes

    B = cell.global_batch
    lead = lead_axes(cfg, mesh, B, cell.kind)
    b_local = B // math.prod(mesh.shape[a] for a in lead)
    act_item = torch.empty((), dtype=getattr(torch, cfg.param_dtype)).element_size()
    train = cell.kind == "train"
    passes = 1 + (2 if cfg.remat == "full" else 1) * train  # forward, backward, recompute
    out = []

    def add(kind, axes, b, trips, src, comp):
        n = math.prod(mesh.shape[a] for a in axes)
        if n > 1 and trips:
            out.append({"op": kind, "axis": "+".join(axes), "bytes_each": float(b),
                        "trips": float(trips), "bytes_total": float(b) * trips,
                        "wire_total": _wire(kind, n, b) * trips,
                        "rate": _group_rate(mesh, axes), "comp": comp, "src": src})

    specs = dict(_leaves(pspec))
    for path, place in _leaves(pplace):
        spec, name = specs[path], str(path[-1])
        if cfg.family == "audio" and cell.kind == "decode" and path[0] == "enc_layers":
            continue  # the encoder does not run at decode
        stacked = path[0] in _LISTS[cfg.family]
        trips = place.shape[0] if stacked else 1
        comp = "/".join(str(p) for p in path)
        axes = _spec_axes(spec)
        expert = len(place.shape) == 4 and len(spec) > 1 and spec[1] == "data"
        gathered = place.rank_bytes * math.prod(
            mesh.shape[a] for a in axes if a == "data" or a == "pod")
        if "data" in axes and not (expert and cfg.moe_ep):
            add("all-gather", ("data",), gathered, (2 if train else 1), "fsdp gather", comp)
        if expert and cfg.moe_ep:
            tok = b_local * _act_len(path, cfg, cell) * cfg.experts_per_token
            b = tok * cfg.d_model * act_item * cfg.capacity_factor
            if name == "w_gate":  # one pair of exchanges a MoE layer
                add("all-to-all", ("data",), b, 2 * trips * (2 if train else 1),
                    "moe_ep dispatch and combine", comp)
        row = None
        if name in _IN_FIRST and len(spec) >= 2:
            row = spec[-2]
        elif name == "embed" and spec:
            row = spec[0]
        if row is not None and "model" in _axes(row) and "model" not in lead:
            b = b_local * _act_len(path, cfg, cell) * cfg.d_model * act_item
            add("all-reduce", ("model",), b, trips * (1 if name == "embed" else passes),
                "tensor-parallel activations", comp)
        if train:
            split = tuple(a for a in lead if a in axes)
            rest = tuple(a for a in lead if a not in axes)
            full = place.rank_bytes * math.prod(mesh.shape[a] for a in split)
            shard = full // max(1, math.prod(mesh.shape[a] for a in split))
            add("reduce-scatter", split, full, 1, "gradient", comp)
            add("all-reduce", rest, shard, 1, "gradient", comp)
    return out


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------


def abstract_cell(cfg, cell, device):
    """``(bundle, args, (param tree, optimizer tree))``: the cell's bundle,
    its step's fake arguments (``step_for_cell``'s) and their reference
    trees (``interop.reference_tree``/``opt_tree``, the optimizer's None
    outside train), made once a cell: its meshes share them."""
    from repro_torch.interop import opt_tree, reference_tree
    from repro_torch.models import build_model

    key = (cfg, cell, str(device))
    if key not in _CELLS:
        bundle = build_model(cfg, device=device)
        _, args = bundle.step_for_cell(cell)
        trees = (reference_tree(args[0], leaf=_meta),
                 opt_tree(args[0], args[1], leaf=_meta) if cell.kind == "train" else None)
        _CELLS[key] = (bundle, args, trees)
    return _CELLS[key]


@functools.lru_cache(maxsize=None)
def _active_params(cfg) -> int:
    return cfg.active_param_count()


def model_flops(cfg, cell) -> int:
    """The JAX dry run's model FLOPs: 6 (train) or 2 x active parameters x
    the cell's tokens (a decode step's one a sequence)."""
    tokens = cell.global_batch * (cell.seq_len if cell.kind == "train" else 1)
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
    return (6 if cell.kind == "train" else 2) * _active_params(cfg) * tokens


def _rank_bytes(placements) -> int:
    from repro_torch.distributed.sharding import rank_bytes

    return rank_bytes(placements)


def run_cell(arch: str, shape: str, multi_pod: bool, verbose: bool = True,
             overrides: dict | None = None, tag: str = "",
             dump_hlo: str | None = None, *, device="cuda", mesh=None, cell=None) -> dict:
    """Price one cell (module docstring) and return its record.
    ``device`` is where the fake tensors live (a fake CUDA tensor prices
    the card's kernel calls, and a call the card would refuse raises);
    ``mesh`` defaults to the production mesh, ``cell`` to ``SHAPES[shape]``
    (a cell one card or the CPU can hold, for the smoke run and the tests).
    ``dump_hlo`` names a file for the priced graphs' code (nothing is
    lowered, so there is no HLO)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.sharding import (
        cache_specs,
        input_specs_sharding,
        lead_axes,
        opt_specs,
        param_specs,
        to_named,
    )
    from repro_torch.launch.mesh import make_production_mesh

    t0 = time.time()
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    chips = mesh.size
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.with_overrides(**overrides)
    cell = cell or SHAPES[shape]
    bundle, args, (ptree, otree) = abstract_cell(cfg, cell, device)
    rec = {
        "key": cell_key(arch, shape, multi_pod, tag),
        "arch": arch,
        "shape": shape,
        "mesh": "multi" if multi_pod else "single",
        "chips": int(chips),
        "kind": cell.kind,
        "tag": tag,
        "overrides": dict(overrides or {}),
        "ok": False,
    }

    params = args[0]
    psp = param_specs(ptree, cfg, mesh)
    pplace = to_named(psp, mesh, ptree)
    if cell.kind == "train":
        _, opt, batch = args
        in_place = (pplace, to_named(opt_specs(otree, psp, cfg, mesh), mesh, otree),
                    to_named(input_specs_sharding(batch, cfg, mesh), mesh, batch))
        donate = (0, 1)
        inputs = batch
    elif cell.kind == "prefill":
        _, inputs = args
        in_place = (pplace, to_named(input_specs_sharding(inputs, cfg, mesh), mesh, inputs))
        donate = ()
    else:  # decode
        _, cache, tok = args
        tok_sh = input_specs_sharding({"tokens": tok}, cfg, mesh)["tokens"]
        in_place = (pplace, to_named(cache_specs(cache, cfg, mesh), mesh, cache),
                    to_named(tok_sh, mesh, tok))
        donate = (1,)
        inputs = {"cache": cache, "tokens": tok}

    priced = price_step(bundle, cell, params, inputs)
    rec["lower_s"] = round(time.time() - t0, 1)
    rec["compile_s"] = 0.0
    if dump_hlo:
        with open(dump_hlo, "w") as f:
            f.write("\n\n".join(priced["codes"]))

    lead = lead_axes(cfg, mesh, cell.global_batch, cell.kind)
    batch_ranks = math.prod(mesh.shape[a] for a in lead)
    arg_bytes = sum(_rank_bytes(p) for p in in_place)
    alias = sum(_rank_bytes(in_place[i]) for i in donate)
    if cell.kind == "train":
        out_bytes = _rank_bytes(in_place[0]) + _rank_bytes(in_place[1]) + 4  # + f32 loss
    else:
        logits, cache_out = priced["outputs"]
        out_bytes = (_rank_bytes(to_named(input_specs_sharding({"x": logits}, cfg, mesh)["x"],
                                          mesh, logits))
                     + _rank_bytes(to_named(cache_specs(cache_out, cfg, mesh), mesh,
                                            cache_out)))
    rec["memory"] = {
        "argument_size_in_bytes": int(arg_bytes),
        "output_size_in_bytes": int(out_bytes),
        "temp_size_in_bytes": int(priced["temp"] // batch_ranks),
        "alias_size_in_bytes": int(alias),
        "generated_code_size_in_bytes": 0,
    }
    rec["memory"]["per_device_total"] = (
        rec["memory"]["argument_size_in_bytes"]
        + rec["memory"]["output_size_in_bytes"]
        + rec["memory"]["temp_size_in_bytes"]
        - rec["memory"]["alias_size_in_bytes"]
    )
    if verbose:
        print(rec["memory"])

    act, opt = priced["act"], priced["opt"]
    tp = "model" not in lead and "model" in mesh.shape and any(
        "model" in _spec_axes(s) for _, s in _leaves(psp))
    split_act = batch_ranks * (mesh.shape["model"] if tp else 1)
    split_opt = 1.0
    if cell.kind == "train":
        moments = in_place[1]["m"]
        split_opt = (sum(math.prod(p.shape) * p.itemsize for _, p in _leaves(moments))
                     / max(1, _rank_bytes(moments)))
    flops_pd = act.flops / split_act + opt.flops / split_opt
    hbm_pd = act.hbm_bytes / split_act + opt.hbm_bytes / split_opt
    rec["graph_cost"] = {"flops": act.flops + opt.flops,
                         "bytes_accessed": act.hbm_bytes + opt.hbm_bytes}
    if verbose:
        print(rec["graph_cost"])

    colls = collectives(cfg, cell, mesh, psp, pplace)
    comm = Counter()
    for c in colls:
        comm[c["op"]] += c["bytes_total"]
    wire = sum(c["wire_total"] for c in colls)
    rec["parsed"] = {
        "flops_per_device": flops_pd,
        "hbm_bytes_per_device": hbm_pd,
        "comm_bytes_per_device": dict(comm),
        "comm_bytes_total_per_device": sum(comm.values()),
        "wire_bytes_per_device": wire,
        "unknown_trip_loops": 0,
        "n_computations": priced["graphs"],
    }
    rec["top_collectives"] = [{k: c[k] for k in ("op", "axis", "bytes_each", "trips",
                                                  "bytes_total", "comp", "src")}
                              for c in sorted(colls, key=lambda c: -c["bytes_total"])[:8]]
    rec["kernel_calls"] = priced["calls"]  # the step's, over all its layers
    rec["signatures"] = priced["signatures"]  # layers a signature
    rec["kernel_calls_per_layer"] = priced["layer_calls"]  # one layer's, a signature

    compute_s = flops_pd / PEAK_FLOPS
    memory_s = hbm_pd / HBM_BW
    coll_s = sum(c["wire_total"] / c["rate"] for c in colls)
    dominant = max(
        [("compute", compute_s), ("memory", memory_s), ("collective", coll_s)],
        key=lambda t: t[1],
    )[0]

    mf = model_flops(cfg, cell)
    total = flops_pd * chips
    rec["roofline"] = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "dominant": dominant,
        "model_flops": mf,
        "useful_ratio": mf / total if total else 0.0,
        "step_time_s": max(compute_s, memory_s, coll_s),
        "roofline_fraction": compute_s / max(compute_s, memory_s, coll_s)
        if max(compute_s, memory_s, coll_s) > 0
        else 0.0,
    }
    rec["ok"] = True
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------


def load_done(jsonl_path):
    done = {}
    if os.path.exists(jsonl_path):
        with open(jsonl_path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done[r["key"]] = r
                except json.JSONDecodeError:
                    pass
    return done


def append_record(jsonl_path, rec):
    os.makedirs(os.path.dirname(jsonl_path), exist_ok=True)
    with open(jsonl_path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def run_all(jsonl_path, multi_pod_too=True, retry_failed=False, timeout=3000, device="cuda"):
    """Every ``ASSIGNED`` arch x its ``shape_cells()`` (x both meshes), one
    subprocess a cell; cells already in ``jsonl_path`` are skipped (failed
    ones too, unless ``retry_failed``), and a cell that fails or times out
    is recorded ``ok: False`` with its error while the sweep goes on."""
    from repro_torch.configs import ASSIGNED, get_config

    done = load_done(jsonl_path)
    cells = []
    for mp in ([False, True] if multi_pod_too else [False]):
        for arch in ASSIGNED:
            for cell in get_config(arch).shape_cells():
                cells.append((arch, cell.name, mp))
    todo = [
        c
        for c in cells
        if cell_key(*c) not in done or (retry_failed and not done[cell_key(*c)].get("ok"))
    ]
    print(f"dry-run sweep: {len(cells)} cells, {len(cells)-len(todo)} done, {len(todo)} to go")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", ".."), env.get("PYTHONPATH", "")]
    )
    for i, (arch, shape, mp) in enumerate(todo):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
               shape, "--jsonl", jsonl_path, "--device", str(device)]
        if mp:
            cmd.append("--multi-pod")
        print(f"[{i+1}/{len(todo)}] {cell_key(arch, shape, mp)}", flush=True)
        try:
            r = subprocess.run(cmd, env=env, timeout=timeout, capture_output=True, text=True)
            if r.returncode != 0:
                append_record(
                    jsonl_path,
                    {
                        "key": cell_key(arch, shape, mp), "arch": arch, "shape": shape,
                        "mesh": "multi" if mp else "single", "ok": False,
                        "error": (r.stderr or "")[-2000:],
                    },
                )
                print(f"  FAILED rc={r.returncode}: {(r.stderr or '')[-300:]}", flush=True)
        except subprocess.TimeoutExpired:
            append_record(
                jsonl_path,
                {
                    "key": cell_key(arch, shape, mp), "arch": arch, "shape": shape,
                    "mesh": "multi" if mp else "single", "ok": False, "error": "timeout",
                },
            )
            print("  TIMEOUT", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry-run: trace + price + roofline")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--retry-failed", action="store_true")
    ap.add_argument("--jsonl", default=os.path.normpath(DEFAULT_JSONL))
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (perf iteration)")
    ap.add_argument("--tag", default="", help="label for this perf variant")
    ap.add_argument("--dump-hlo", default=None,
                    help="write the priced graphs' code here (nothing is lowered)")
    ap.add_argument("--device", default="cuda",
                    help="where the fake tensors live (cpu on a host without a card)")
    args = ap.parse_args(argv)

    if args.all:
        run_all(args.jsonl, multi_pod_too=not args.single_pod_only,
                retry_failed=args.retry_failed, device=args.device)
        return

    overrides = dict(_parse_override(s) for s in args.override)
    try:
        rec = run_cell(args.arch, args.shape, args.multi_pod,
                       overrides=overrides, tag=args.tag, dump_hlo=args.dump_hlo,
                       device=args.device)
    except Exception:
        rec = {
            "key": cell_key(args.arch, args.shape, args.multi_pod, args.tag),
            "arch": args.arch, "shape": args.shape,
            "mesh": "multi" if args.multi_pod else "single", "tag": args.tag,
            "ok": False, "error": traceback.format_exc()[-2000:],
        }
        append_record(args.jsonl, rec)
        print(json.dumps({k: rec[k] for k in ("key", "ok")}, indent=2))
        raise
    append_record(args.jsonl, rec)
    print(json.dumps(rec, indent=2, default=str))


if __name__ == "__main__":
    main()
