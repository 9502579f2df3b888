"""K-Means (paper §6.2, Fig. 16) — the iterative-app pattern.

Two execution strategies, the exact contrast the paper draws:

  ignis mode — the whole iteration loop stays ON the device: the driver
               never evaluates intermediate results (paper §3.6's "no
               driver evaluations"); nothing waits for the card until the
               caller reads the centres.
  spark mode — one driver evaluation per iteration: the new centres are
               copied to the host, and sent back for the next step (Spark's
               stop-executors / driver / restart-executors cycle).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.native import ignis_export


def make_points(n: int = 4096, d: int = 16, k: int = 8, seed: int = 0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 5
    asg = rng.integers(0, k, n)
    pts = centers[asg] + rng.normal(size=(n, d))
    return pts.astype(np.float32), centers.astype(np.float32)


def _assign(pts, centers):
    # the reference's (p - c)² form, so argmin ties break alike
    d2 = ((pts[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    return torch.argmin(d2, dim=1)


def _update(pts, asg, k):
    oh = torch.nn.functional.one_hot(asg, k).to(pts.dtype)  # (n, k)
    sums = oh.T @ pts  # (k, d)
    counts = oh.sum(0)[:, None]
    return sums / torch.clamp_min(counts, 1.0)


def kmeans_on_device(pts, centers0, iters: int):
    """ignis mode: the whole loop on the device, no host sync."""
    k = centers0.shape[0]
    centers = centers0
    for _ in range(iters):
        centers = _update(pts, _assign(pts, centers), k)
    return centers


def kmeans_driver_eval(pts_dev, centers0, iters: int):
    """spark mode: per-iteration driver evaluation (a host copy each step)."""
    k = centers0.shape[0]
    centers = (centers0.cpu().numpy() if isinstance(centers0, torch.Tensor)
               else np.asarray(centers0))
    for _ in range(iters):
        asg = _assign(pts_dev, torch.from_numpy(centers).to(pts_dev.device))
        partial = _update(pts_dev, asg, k)
        centers = partial.cpu().numpy()  # driver round-trip
    return torch.from_numpy(centers).to(pts_dev.device)


@ignis_export("kmeans_mpi")
def kmeans_native(ctx, data=None, valid=None):
    """Native-app form (paper Fig. 12 pattern): data rows = points. The
    initial centres are k distinct rows drawn by a ``torch.Generator``
    seeded with the ``seed`` var."""
    iters = int(ctx.var("iters", 10))
    k = int(ctx.var("k", 8))
    seed = int(ctx.var("seed", 0))
    pts = data
    g = torch.Generator().manual_seed(seed)
    pick = torch.randperm(pts.shape[0], generator=g)[:k].to(pts.device)
    centers = kmeans_on_device(pts, pts[pick], iters)
    return centers, torch.ones((k,), dtype=torch.bool, device=pts.device)
