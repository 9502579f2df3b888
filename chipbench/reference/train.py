"""Training, written out plainly: documents packed into rows and cut into
batches, the learning-rate schedule, AdamW, and the first steps of a run.

Packing: each document is framed as ``[bos, tokens..., eos]``, the frames
are concatenated and cut into whole rows of ``seq_len + 1`` (the tail past
the last whole row is dropped; a stream shorter than one row is padded with
``pad``). Batching: each epoch takes the rows in the order of
``numpy.random.default_rng(seed).permutation``, ``batch`` at a time;
tokens are a row's first ``seq_len`` ids, labels its last ``seq_len``,
with ``pad`` labels set to -1 (no loss).

AdamW (decoupled weight decay on every leaf, bias-corrected moments kept in
float32): ``m = b1 m + (1-b1) g``, ``v = b2 v + (1-b2) g^2``,
``p -= lr ((m/c1) / (sqrt(v/c2) + eps) + wd p)``, each parameter stored
back in its own dtype. The schedule: a linear warm-up to ``peak_lr``, then a
cosine down to ``floor`` x ``peak_lr`` at ``total``; update ``t`` (from 1)
takes the rate at ``t - 1``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.95, 1e-8, 0.1


def pack(docs, seq_len: int, fmt: dict) -> np.ndarray:
    L = seq_len + 1
    parts = []
    for d in docs:
        parts += [np.asarray([fmt["bos"]], np.int64), np.asarray(d, np.int64),
                  np.asarray([fmt["eos"]], np.int64)]
    stream = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    n = max(len(stream) // L, 1)
    rows = np.full(n * L, fmt["pad"], np.int64)
    take = min(len(stream), n * L)
    rows[:take] = stream[:take]
    return rows.reshape(n, L)


def batches(rows: np.ndarray, batch: int, seed: int, count: int, fmt: dict) -> list:
    """The first ``count`` batches, ``{"tokens", "labels"}`` as int64."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        order = rng.permutation(len(rows))
        for i in range(0, (len(order) // batch) * batch, batch):
            sel = rows[order[i:i + batch]]
            labels = sel[:, 1:]
            out.append({"tokens": sel[:, :-1],
                        "labels": np.where(labels != fmt["pad"], labels, -1)})
            if len(out) == count:
                break
    return out


def learning_rate(step: int, peak_lr: float, warmup: int, total: int, floor=0.1) -> float:
    if step < warmup:
        return peak_lr * step / max(warmup, 1)
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak_lr * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * frac)))


def first_steps(model, init: dict, dtypes: dict, batches_dev: list, sz: dict, sched: dict,
                mode="f32") -> dict:
    """Train from ``init`` (``{name: tensor}`` as drawn; each leaf stored in
    ``dtypes[name]``) on ``batches_dev`` one step each, the loss and
    gradients by ``model.train_loss`` in float32 (fp8 products under the
    control). Returns each step's loss, each leaf's gradient norm at step 1
    and its change ``|p_n - p_0|`` after the last step, as stored."""
    stored = {k: v.detach().to(dtypes[k]).clone() for k, v in init.items()}
    m = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device) for k, v in init.items()}
    v2 = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device) for k, v in init.items()}
    losses, g1 = [], None
    for t, batch in enumerate(batches_dev, start=1):
        P = {k: x.float().requires_grad_() for k, x in stored.items()}
        loss = model.train_loss(P, batch, sz, mode)
        grads = torch.autograd.grad(loss, list(P.values()))
        losses.append(float(loss.detach()))
        if t == 1:
            g1 = dict(zip(P, torch.stack([g.norm() for g in grads]).tolist()))
        lr = learning_rate(t - 1, sched["peak_lr"], sched["warmup"], sched["total"])
        c1, c2 = 1 - B1 ** t, 1 - B2 ** t
        with torch.no_grad():
            for (k, p), g in zip(P.items(), grads):
                m[k].mul_(B1).add_(g, alpha=1 - B1)
                v2[k].mul_(B2).addcmul_(g, g, value=1 - B2)
                delta = (m[k] / c1) / (torch.sqrt(v2[k] / c2) + EPS) + WEIGHT_DECAY * p
                stored[k] = (p - lr * delta).to(dtypes[k])
        del P, grads, loss
    with torch.no_grad():
        change = dict(zip(stored, torch.stack(
            [(stored[k].float() - init[k].float()).norm() for k in stored]).tolist()))
    return {"losses": losses, "grad_norms": g1, "change_norms": change}
