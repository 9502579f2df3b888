"""Scenarios the torch port is held against the JAX package on.

Each case builds one lineage on a worker of either package and returns what
its actions produced, each action run twice. The row functions are written
once for both frameworks (``x % 13`` means the same to a jax and a torch
tensor); the few framework-specific pieces — max/min functions, the native
wordcount app, the IJob class — come in through ``ops``.

Used in-process at p=1 by tests/test_torch_slice.py and, for the JAX side at
p=8, by tests/_torch_parity_main.py in a subprocess.
"""
from __future__ import annotations

import numpy as np

VALS = np.random.default_rng(7).integers(0, 5000, 384).astype(np.int32)
WORDS = (np.random.default_rng(8).zipf(1.3, 512) % 97).astype(np.int32)
VOCAB = 97

#: shuffle / kernel / stage counters compared between the two packages
COUNTERS = ("exchanges", "overflow_retries", "fanout_retries",
            "capacity_memory_hits", "capacity_memory_misses", "wide_plan_hits",
            "wide_plan_misses", "bytes_moved", "kernel_hits", "kernel_fallbacks")
STAGE_COUNTERS = ("fused_stages", "plan_cache_hits", "plan_cache_misses")


def norm(x):
    """A framework-free, order-free rendering of a collected row."""
    if isinstance(x, dict):
        return tuple((k, norm(v)) for k, v in sorted(x.items()))
    if isinstance(x, (tuple, list)):
        return tuple(norm(v) for v in x)
    a = np.asarray(x)
    return (str(a.dtype), a.tolist())


def rows_key(rows) -> list:
    return sorted(repr(norm(r)) for r in rows)


def _wordcount(ops):
    def build(w):
        return w.call(ops["app"], w.parallelize(WORDS), vocab=VOCAB)

    return build


CASES = {
    "wordcount": lambda ops: (
        lambda w: _wordcount(ops)(w), "collect"),
    "filter_rbk_add": lambda ops: (
        lambda w: w.parallelize(VALS).filter(lambda x: x % 3 != 0)
        .map(lambda x: {"key": x % 13, "value": x})
        .reduce_by_key(lambda a, b: a + b, 0), "collect"),
    "filter_rbk_max": lambda ops: (
        lambda w: w.parallelize(VALS).filter(lambda x: x % 3 != 0)
        .map(lambda x: {"key": x % 13, "value": x})
        .reduce_by_key(ops["max"], 0), "collect"),
    "filter_rbk_min": lambda ops: (
        lambda w: w.parallelize(VALS).filter(lambda x: x % 3 != 0)
        .map(lambda x: {"key": x % 13, "value": x})
        .reduce_by_key(ops["min"], 2**31 - 1), "collect"),
    "rbk_nonbuiltin": lambda ops: (
        lambda w: w.parallelize(VALS).map(lambda x: {"key": x % 5, "value": x})
        .reduce_by_key(lambda a, b: a + b + 1, 0), "collect"),
    "sort": lambda ops: (lambda w: w.parallelize(VALS).sort(), "collect"),
    "sort_by_desc": lambda ops: (
        lambda w: w.parallelize(VALS).map(lambda x: x * 2 + 1)
        .sort_by(lambda x: x % 1000, ascending=False), "collect"),
    "distinct": lambda ops: (
        lambda w: w.parallelize(VALS).map(lambda x: x % 17).distinct(), "collect"),
    "group_by_key": lambda ops: (
        lambda w: w.parallelize(VALS).map(lambda x: {"key": x % 11, "value": x})
        .group_by_key(), "collect"),
    "partition_by": lambda ops: (
        lambda w: w.parallelize(VALS).map(lambda x: {"key": x % 13, "value": x})
        .partition_by(), "collect"),
    "join": lambda ops: (
        lambda w: w.parallelize(VALS).map(lambda x: {"key": x % 7, "value": x})
        .join(w.parallelize(VALS[:96]).map(lambda x: {"key": x % 9, "value": x * 2}),
              max_matches=4), "collect"),
    "ijob_two_branches": lambda ops: (
        lambda w: (w.parallelize(WORDS).map(lambda x: {"key": x, "value": 1})
                   .reduce_by_key(lambda a, b: a + b, 0), _wordcount(ops)(w)),
        "job"),
}


def run_case(name: str, core, ops, mode: str, p: int, extra_props=None) -> dict:
    """Run case ``name`` on a fresh worker of package ``core`` (``repro.core``
    or ``repro_torch.core``); every action twice. Returns rows (as sorted
    reprs), the counters, and the stage counters."""
    import warnings

    props = {"ignis.executor.instances": str(p), "ignis.kernels": mode,
             **(extra_props or {})}
    w = core.IWorker(core.ICluster(core.IProperties(props)), "python")
    build, action = CASES[name](ops)
    outs = []
    for _ in range(2):
        frames = build(w)
        if action == "collect":
            outs.append([rows_key(frames.collect())])
        else:
            job = core.IJob(f"parity-{name}")
            f1 = frames[0].count_async(job=job)
            f2 = frames[1].collect_async(job=job)
            f3 = frames[0].collect_async(job=job)
            outs.append([[repr(f1.result())], rows_key(f2.result()),
                         rows_key(f3.result())])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        s, st = w.shuffle_stats(), w.stage_stats()
    return {"rows": outs, "counters": [int(s[k]) for k in COUNTERS],
            "stages": [int(st[k]) for k in STAGE_COUNTERS]}


def jax_ops():
    import jax.numpy as jnp

    from repro.core.native import ignis_export

    @ignis_export("parity_wordcount")
    def parity_wordcount(ctx, data=None, valid=None):
        vocab = int(ctx.var("vocab"))
        counts = jnp.bincount(jnp.where(valid, data, vocab), length=vocab + 1)[:-1]
        keys = jnp.arange(vocab, dtype=jnp.int32)
        return {"key": keys, "value": counts}, counts > 0

    return {"max": jnp.maximum, "min": jnp.minimum, "app": "parity_wordcount"}


def torch_ops():
    import torch

    from repro_torch.core.native import ignis_export

    @ignis_export("parity_wordcount")
    def parity_wordcount(ctx, data=None, valid=None):
        vocab = int(ctx.var("vocab"))
        ids = torch.where(valid, data, vocab).long()
        counts = torch.bincount(ids, minlength=vocab + 1)[:-1].to(torch.int32)
        keys = torch.arange(vocab, dtype=torch.int32, device=data.device)
        return {"key": keys, "value": counts}, counts > 0

    return {"max": torch.maximum, "min": torch.minimum, "app": "parity_wordcount"}


def reduced_block_leaves(core, mode: str, p: int, extra_props=None) -> dict:
    """The capacity-padded block a reduceByKey stage leaves behind (every
    row, padding and positions included), as numpy leaves."""
    props = {"ignis.executor.instances": str(p), "ignis.kernels": mode,
             **(extra_props or {})}
    w = core.IWorker(core.ICluster(core.IProperties(props)), "python")
    df = (w.parallelize(VALS).filter(lambda x: x % 3 != 0)
          .map(lambda x: {"key": x % 13, "value": x})
          .reduce_by_key(lambda a, b: a + b, 0))
    (b,) = w.engine.evaluate(df.node)
    return {"key": np.asarray(b.data["key"].tolist()),
            "value": np.asarray(b.data["value"].tolist()),
            "valid": np.asarray(b.valid.tolist())}
