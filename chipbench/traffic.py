"""The one generator of every traffic mix: it reads a mix's parameters
(``chipbench/traffic/<mix>.json``) and makes the run's inputs from its seed.

Sizes come from the mix alone: a length law (``lognormal``: ``median``,
``sigma``, clipped to ``[min, max]``) is sampled at evenly spaced
quantiles, so every seed gets the same multiset of lengths. The seed picks
the documents' order and every token id. So runs with different seeds do
the same work on different data.
"""
from __future__ import annotations

import math
import statistics

import numpy as np

from chipbench.common import seed_of


def lengths(law: dict, n: int) -> np.ndarray:
    """``n`` lengths of ``law`` at the quantiles (i + 1/2) / n, ascending."""
    if law["law"] != "lognormal":
        raise ValueError(f"length law {law['law']!r}; known: lognormal")
    nd = statistics.NormalDist()
    q = [nd.inv_cdf((i + 0.5) / n) for i in range(n)]
    x = np.round(law["median"] * np.exp(law["sigma"] * np.asarray(q)))
    return np.clip(x, law["min"], law["max"]).astype(np.int64)


def first_id(mix: dict) -> int:
    """Token ids start above the data format's markers."""
    fmt = mix.get("format")
    return max(fmt.values()) + 1 if fmt else 0


def documents(mix: dict, seed: int, vocab: int) -> list:
    """Documents whose framed lengths fill ``rows`` rows of ``seq_len + 1``
    ids; lengths in an order drawn from the seed, ids uniform over the
    vocabulary above the format's markers."""
    need = mix["rows"] * (mix["seq_len"] + 1)
    law = mix["documents"]
    n = max(1, math.ceil(need / law["median"]))
    while True:
        lens = lengths(law, n)
        if int((lens + 2).sum()) >= need:
            break
        n = math.ceil(n * 1.25)
    rng = np.random.default_rng(seed_of(seed, "documents"))
    lens = lens[rng.permutation(n)]
    ids = rng.integers(first_id(mix), vocab, int(lens.sum()), dtype=np.int64)
    return [d.astype(np.int32) for d in np.split(ids, np.cumsum(lens)[:-1])]


def requests(mix: dict, seed: int, vocab: int) -> list:
    """``(prompt (int32), max_new_tokens)`` for ``requests`` requests: the
    prompt and output laws at quantiles, paired and ordered by a fixed
    permutation, so every seed sends the same lengths in the same order and
    every run sees the same ticks; the seed draws the prompts' ids. The
    first ``clients`` are in flight when the window opens: their budgets are
    what remains of theirs (at least 2), at evenly spread fractions, so
    retirements are spread from the first tick on."""
    n, c = mix["requests"], mix["clients"]
    fixed = np.random.default_rng(0)
    prompts = lengths(mix["prompt"], n)[fixed.permutation(n)]
    outs = lengths(mix["output"], n)[fixed.permutation(n)]
    left = (np.arange(c) + 0.5)[fixed.permutation(c)] / c
    outs[:c] = np.maximum(2, np.ceil(left * outs[:c])).astype(np.int64)
    rng = np.random.default_rng(seed_of(seed, "requests"))
    ids = rng.integers(first_id(mix), vocab, int(prompts.sum()), dtype=np.int64)
    split = np.split(ids.astype(np.int32), np.cumsum(prompts)[:-1])
    return list(zip(split, outs.tolist()))
