"""Training entry point: ``python -m repro_torch.launch.train --arch <id> [...]``
(the port of ``repro.launch.train``).

Production loop on one card: AdamW with the warm-up/cosine schedule,
optional gradient compression with error feedback, the double-buffered data
feed, asynchronous checkpoints and restart from the latest one, per-step
metrics. ``mesh`` (``launch.mesh``) places the parameters and the optimizer
state by the config's sharding preset (``param_specs``/``opt_specs``, ZeRO-1
under ``*_zero1``) and the batch by ``lead_axes``, as the JAX loop does; its
ranks are virtual ranks on the mesh's device, so the placement is
bookkeeping (``train_placement``) and the arithmetic is the same as without
one. A caller with no mesh names the ``device`` (``cuda`` unless the caller
passes ``device="cpu"``).

The loop feeds token batches (``tokens``, ``labels``), as the JAX one does:
it trains the dense, MoE, SSM and hybrid families and the VLM without its
patch prefix; the audio family's loss needs ``frames``, so Whisper trains
through ``bundle.train_step`` with its own batches.

Checkpoints carry the JAX package's tree — ``params`` with the layers
stacked on a leading axis and ``opt`` as ``{m, v, step}`` — in its on-disk
format, so a run saved by either package resumes in the other. As in the
JAX training loop, a resumed run restarts its data iterator, and the error
feedback of the compression is not checkpointed.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import get_config
from repro_torch.data.pipeline import TrainPipeline, batches_from_rows, pack_sequences
from repro_torch.data.synthetic import synthetic_batches, synthetic_corpus
from repro_torch.distributed.compression import compressed_grads, init_ef_state
from repro_torch.distributed.sharding import (
    P,
    Placement,
    lead_axes,
    opt_specs,
    param_specs,
    rank_bytes,
    to_named,
)
from repro_torch.interop import load_reference, opt_from_reference, opt_tree, reference_tree
from repro_torch.models import build_model
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.profile.spans import span


def make_train_step(bundle, cfg, *, compression="none", peak_lr=3e-4,
                    warmup=20, total=1000):
    from repro_torch.optim.adamw import adamw_update

    def step(params, opt, ef, batch):
        tokens = batch["tokens"]
        with span("train.step", tokens):
            loss, grads = bundle.value_and_grad(params, batch)
            if compression != "none":
                grads, ef = compressed_grads(grads, ef, compression)
            lr = warmup_cosine(opt["step"], peak_lr, warmup, total)
            with span("train.optimizer", tokens) as sp:
                if sp:
                    sp.args["leaves"] = len(grads)
                params, opt = adamw_update(grads, opt, params, lr=lr)
        return params, opt, ef, loss

    return step


def checkpoint_tree(params, opt, leaf=lambda t: t.detach().cpu()):
    """``{"params", "opt"}`` in the JAX package's tree (``interop.
    reference_tree``): what a checkpoint holds."""
    return {"params": reference_tree(params, leaf=leaf), "opt": opt_tree(params, opt, leaf)}


def restore_checkpoint(ckpt_dir, step, params, opt):
    """Load checkpoint ``step`` into ``params`` (in place); returns the
    restored optimizer state."""
    target = checkpoint_tree(params, opt, leaf=lambda t: t.to("meta"))
    state = restore(ckpt_dir, step, target, "cpu")
    load_reference(params, state["params"])
    return opt_from_reference(state["opt"], params)


def train_placement(params, opt, cfg, mesh, batch: int, seq_len: int) -> dict:
    """Where the train state and the token batch live on ``mesh``'s ranks:
    ``{"params", "opt"}`` as trees of ``Placement`` in the JAX package's
    tree (``checkpoint_tree``), ``"batch"`` the (batch, seq_len) token
    batch's placement (``P(lead_axes)`` or replicated)."""
    state = checkpoint_tree(params, opt, leaf=lambda t: t.to("meta"))
    psp = param_specs(state["params"], cfg, mesh)
    lead = lead_axes(cfg, mesh, batch, "train")
    return {"params": to_named(psp, mesh, state["params"]),
            "opt": to_named(opt_specs(state["opt"], psp, cfg, mesh), mesh, state["opt"]),
            "batch": Placement(mesh, P(lead, None) if lead else P(), (batch, seq_len), 4)}


def train(arch="ignis-100m", steps=100, batch=8, seq_len=256, ckpt_dir=None,
          ckpt_every=50, compression="none", data="synthetic", reduced=False,
          device="cuda", mesh=None, log_every=10, resume=True, seed=0):
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if mesh is not None:
        device = mesh.device
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device=device).manual_seed(seed))
    opt = bundle.init_opt(params)
    ef = init_ef_state(params) if compression != "none" else None
    if mesh is not None:
        placed = train_placement(params, opt, cfg, mesh, batch, seq_len)
        print(f"[train] {cfg.sharding_preset} on {mesh}: {rank_bytes(placed['params'])} "
              f"parameter and {rank_bytes(placed['opt'])} optimizer bytes a rank, batch "
              f"{placed['batch'].spec}", flush=True)

    start = 0
    ckptr = None
    if ckpt_dir:
        ckptr = AsyncCheckpointer(ckpt_dir)
        last = latest_step(ckpt_dir) if resume else None
        if last is not None:
            opt = restore_checkpoint(ckpt_dir, last, params, opt)
            start = last
            print(f"[train] resumed from step {last}")

    step_fn = make_train_step(bundle, cfg, compression=compression, total=steps)

    if data == "synthetic":
        it = synthetic_batches(cfg.vocab_size, batch, seq_len, seed)
    else:  # the hybrid path: dataflow-prepared corpus
        from repro_torch.data.pipeline import byte_tokenize

        docs = [byte_tokenize(d) for d in synthetic_corpus(seed=seed)]
        rows = pack_sequences(docs, seq_len)
        it = batches_from_rows(rows, batch, seed=seed)
    pipe = TrainPipeline(it, device=device)

    losses = []
    t0 = time.time()
    for i, batch_dev in enumerate(pipe):
        s = start + i
        if s >= steps:
            break
        params, opt, ef, loss = step_fn(params, opt, ef, batch_dev)
        if (s + 1) % log_every == 0 or s == steps - 1:
            l = float(loss)
            losses.append((s + 1, l))
            dt = time.time() - t0
            print(f"[train] step {s+1}/{steps} loss={l:.4f} ({dt:.1f}s)", flush=True)
        if ckptr and (s + 1) % ckpt_every == 0:
            ckptr.save(s + 1, checkpoint_tree(params, opt))
    pipe.close()
    if ckptr:
        ckptr.save(steps, checkpoint_tree(params, opt))
        ckptr.wait()
    return params, opt, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="ignis-100m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compression", default="none", choices=["none", "int8", "topk"])
    ap.add_argument("--data", default="synthetic", choices=["synthetic", "corpus"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    _, _, losses = train(
        a.arch, a.steps, a.batch, a.seq_len, a.ckpt_dir, a.ckpt_every,
        a.compression, a.data, a.reduced, device=a.device, seed=a.seed,
    )
    print(json.dumps({"final_loss": losses[-1][1] if losses else None}))


if __name__ == "__main__":
    main()
