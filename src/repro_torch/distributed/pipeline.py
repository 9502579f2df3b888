"""Pipeline parallelism: GPipe-style microbatch streaming over a "stage"
mesh axis with ring hops (the port of ``repro.distributed.pipeline``; the
hop is ``comm.ppermute``, the Isend/Irecv ring of the port's MPI layer).

``pipeline_apply`` runs a stage-split stack of layers over M microbatches
in M + S - 1 ticks: each tick, stage 0 injects microbatch ``min(t, M-1)``,
every stage applies ``stage_fn`` to its in-flight activation, and the
boundary activations hop stage → stage+1. The last stage emits microbatch
``t - S + 1``; the result is the last stage's outputs.

The stages are the ranks of the mesh's stage axis, virtual ranks on one
device, so the port runs ``stage_fn`` stage by stage in a loop (a kernel
inside ``stage_fn`` cannot run under ``vmap``). Unlike the JAX loop, whose
SPMD program runs ``stage_fn`` on every stage at every tick, the port skips
the bubble: stage ``s`` runs at tick ``t`` only when it holds a real
microbatch (``0 <= t - s < M``). A bubble tick's output is never emitted,
so the result is the same, and ``stage_fn`` runs M·S times, as in
``reference_apply``; a stage idle at a tick sends zeros round the ring.
"""
from __future__ import annotations

import torch

from repro_torch.core import comm


def _stage_slice(tree, s: int):
    """Stage ``s``'s slice of ``tree``: each tensor's row ``s``, each
    ``nn.ModuleList``'s entry ``s`` (a list of stage modules)."""
    if isinstance(tree, torch.nn.ModuleList):
        return tree[s]
    if isinstance(tree, dict):
        return {k: _stage_slice(v, s) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_stage_slice(v, s) for v in tree)
    if tree is None:
        return None
    return tree[s]


def _stages(tree) -> int:
    if isinstance(tree, torch.nn.ModuleList):
        return len(tree)
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            n = _stages(v)
            if n is not None:
                return n
        return None
    return None if tree is None else tree.shape[0]


def pipeline_apply(stage_params, x_micro, stage_fn, mesh, axis: str = "stage"):
    """stage_params: a tree with leading dim S (tensors; an ``nn.ModuleList``
    of S stage modules is sliced by entry). x_micro: (M, mb, …)
    microbatched input. stage_fn(params_slice, x) -> y, one stage's compute,
    with y shaped as x. Returns (M, mb, …), as the LAST stage produced it."""
    ctx = mesh.comm(axis)
    S = ctx.executors
    if _stages(stage_params) != S:
        raise ValueError(f"stage_params has {_stages(stage_params)} stages, mesh axis "
                         f"{axis!r} has {S} ranks")
    M = x_micro.shape[0]
    params = [_stage_slice(stage_params, s) for s in range(S)]
    buf = torch.zeros((S, *x_micro.shape[1:]), dtype=x_micro.dtype, device=x_micro.device)
    outs = [None] * M
    for t in range(M + S - 1):
        ys = []
        for s in range(S):
            if not 0 <= t - s < M:  # the bubble: no microbatch here
                ys.append(torch.zeros_like(buf[s]))
                continue
            x_in = x_micro[min(t, M - 1)] if s == 0 else buf[s]
            ys.append(stage_fn(params[s], x_in))
        m_out = t - (S - 1)
        if m_out >= 0:
            outs[m_out] = ys[S - 1]
        # hop the activation ring: stage i → i+1 (rank-major rows)
        y = torch.stack(ys)
        buf = comm.ppermute(ctx, y.flatten(0, 1) if y.ndim > 1 else y, 1).reshape(y.shape)
    return torch.stack(outs)


def reference_apply(stage_params, x_micro, stage_fn):
    """Sequential oracle: every microbatch through every stage in order."""
    S = _stages(stage_params)

    def one(x):
        for s in range(S):
            x = stage_fn(_stage_slice(stage_params, s), x)
        return x

    return torch.stack([one(x) for x in x_micro])
