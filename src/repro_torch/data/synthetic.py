"""Synthetic corpora for examples/benches (deterministic, no downloads)."""
from __future__ import annotations

import numpy as np

_WORDS = (
    "the of and a to in is you that it he was for on are as with his they I "
    "at be this have from or one had by word but not what all were we when "
    "your can said there use an each which she do how their if will up other "
    "about out many then them these so some her would make like him into time"
).split()


def synthetic_corpus(n_docs: int = 200, words_per_doc: int = 120, seed: int = 0):
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n_docs):
        k = rng.integers(words_per_doc // 2, words_per_doc)
        docs.append(" ".join(rng.choice(_WORDS, size=k)))
    return docs


def synthetic_batches(vocab: int, batch: int, seq_len: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    while True:
        t = rng.integers(0, vocab, (batch, seq_len + 1), dtype=np.int32)
        yield {"tokens": t[:, :-1], "labels": t[:, 1:]}
