"""The numbers that decide ``correct``, and their judgement against a
cell's limits (``chipbench/limits/<cell>.json``: ``{number: limit}``; a
number passes at or below its limit).

Training, from the program's first steps and the reference's:

- ``batch_mismatch``: ids of the first steps' tokens and labels that differ
  from the reference's packing and batching of the same documents (exact).
- ``loss_gap``: the largest relative gap of a step's loss.
- ``grad_gap``: over the leaves, the largest gap between the norms of the
  program's and the reference's first gradient, against the larger of
  that leaf's reference norm and the median leaf's.
- ``change_gap``: the same for the change of the parameters over the
  steps, as stored; leaves whose reference gradient is under a thousandth
  of the median leaf's move by round-off alone and are left out.

Serving, from the requests the window finished:

- ``length_mismatch``: sampled requests whose served tokens are not as many
  as they asked for (exact).
- ``max_gap``: the widest gap by which a served token's reference logit
  lies below the reference's best at its position.
"""
from __future__ import annotations

import math
import statistics

#: a leaf's reference gradient under this share of the median leaf's is
#: nought to rounding
QUIET_LEAF = 1e-3


def _norm_gap(prog: dict, ref: dict, keys) -> tuple:
    keys = list(keys)
    if not keys:
        return 0.0, None
    med = statistics.median(ref[k] for k in keys)
    worst, leaf = -1.0, None
    for k in keys:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if gap > worst:
            worst, leaf = gap, k
    return worst, leaf


def train_numbers(prog: dict, ref: dict, mismatch: int) -> dict:
    """``prog``/``ref``: ``{"losses", "grad_norms", "change_norms"}``."""
    loss_gap = max(abs(a - b) / abs(b) if math.isfinite(a) else math.inf
                   for a, b in zip(prog["losses"], ref["losses"]))
    g, g_leaf = _norm_gap(prog["grad_norms"], ref["grad_norms"], ref["grad_norms"])
    med = statistics.median(ref["grad_norms"].values())
    moving = [k for k, v in ref["grad_norms"].items() if v >= QUIET_LEAF * med]
    c, c_leaf = _norm_gap(prog["change_norms"], ref["change_norms"], moving)
    return {"batch_mismatch": float(mismatch), "loss_gap": loss_gap, "grad_gap": g,
            "change_gap": c, "_grad_leaf": g_leaf, "_change_leaf": c_leaf,
            "_quiet_leaves": len(ref["grad_norms"]) - len(moving)}


def token_gaps(ref_logits, tokens) -> list:
    """The gap below the best of each token's logit, position by position
    (``ref_logits`` (T, V), ``tokens`` T ids)."""
    import torch

    t = torch.as_tensor(tokens, device=ref_logits.device).long()
    best = ref_logits.max(-1).values
    return (best - ref_logits.gather(1, t[:, None])[:, 0]).tolist()


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): each number of ``limits`` beside its limit; a
    number missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        checks[name] = {"value": v if v is None or math.isfinite(v) else str(v),
                        "limit": limit}
    return ok, checks
