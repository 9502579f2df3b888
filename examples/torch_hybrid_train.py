"""End-to-end hybrid training app on the PyTorch port: the paper's pattern at
training scale.

Phase 1 (Big-Data, dataflow worker): corpus ingestion — the documents'
lengths are filtered as IDataFrame ops on the fabric, then the kept ones are
tokenized and packed. Phase 2 (HPC): train the `ignis-tiny` LM (or, with
--full, the ~100M-param `ignis-100m`) with the production train loop
(AdamW, checkpoints at the middle and the end, restart from the latest).
One job, two programming models, one card.

Run:  PYTHONPATH=src python examples/torch_hybrid_train.py [--steps 200]   # on the card
      PYTHONPATH=src python examples/torch_hybrid_train.py --device cpu
"""
import argparse
import os
import shutil
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core import Ignis, ICluster, IProperties, IWorker  # noqa: E402
from repro_torch.data.pipeline import byte_tokenize, pack_sequences  # noqa: E402
from repro_torch.data.synthetic import synthetic_corpus  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402


def dataflow_phase(worker, seq_len: int):
    """Phase 1 on ``worker``: keep the documents of at least 200 bytes (a
    filter over (doc id, length) rows on the fabric), tokenize and pack
    them. Returns (kept doc ids, the corpus size, packed rows)."""
    docs = synthetic_corpus(n_docs=300, words_per_doc=100)
    lengths = worker.parallelize(
        np.asarray([[i, len(d)] for i, d in enumerate(docs)], np.int32)
    )
    kept = lengths.filter(lambda r: r[1] >= 200).cache()
    ids = sorted(int(np.asarray(r[0])) for r in kept.collect())
    toks = [byte_tokenize(docs[i]) for i in ids]
    return ids, len(docs), pack_sequences(toks, seq_len)


def train_phase(arch, steps, batch, seq_len, ckpt_dir, device):
    """Phase 2: ``launch.train.train`` on the corpus, checkpointing at the
    middle step and at the end. Returns its (params, opt, losses)."""
    return train(arch=arch, steps=steps, batch=batch, seq_len=seq_len,
                 ckpt_dir=ckpt_dir, ckpt_every=max(steps // 2, 1), data="corpus",
                 device=device)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="train the full 100M config (slow on the CPU)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary one, removed)")
    a = ap.parse_args()

    Ignis.start()
    worker = IWorker(ICluster(IProperties({"ignis.device": a.device})), "python")

    # ---- Phase 1: dataflow corpus preparation -----------------------------
    ids, n_docs, rows = dataflow_phase(worker, a.seq_len)
    print(f"[hybrid] dataflow filter kept {len(ids)}/{n_docs} docs")
    print(f"[hybrid] packed {rows.shape[0]} training rows of len {rows.shape[1]}")

    # ---- Phase 2: training --------------------------------------------------
    arch = "ignis-100m" if a.full else "ignis-tiny"
    ckpt_dir = a.ckpt_dir or tempfile.mkdtemp(prefix="ignis_hybrid_ckpt_")
    try:
        _, _, losses = train_phase(arch, a.steps, a.batch, a.seq_len, ckpt_dir, a.device)
    finally:
        if a.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    first, last = losses[0][1], losses[-1][1]
    print(f"[hybrid] loss {first:.3f} → {last:.3f}")
    assert last < first, "training did not reduce loss"
    Ignis.stop()
    print("OK")


if __name__ == "__main__":
    main()
