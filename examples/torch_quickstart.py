"""Quickstart — the paper's hybrid Wordcount (Fig. 12) on the PyTorch port.

Big-Data tasks prepare the data on the dataflow worker; the
compute-intensive task is a native SPMD program invoked with worker.call;
results come back as an IDataFrame and are saved as json — all on one
device, no host round-trips between stages.

Run:  PYTHONPATH=src python examples/torch_quickstart.py               # on the card
      PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.core import Ignis, ICluster, IProperties, IWorker  # noqa: E402
from repro_torch.core.native import ignis_export  # noqa: E402
from repro_torch.data.synthetic import synthetic_corpus  # noqa: E402


# --- the "MPI" part: a native SPMD histogram (the paper's wordcount lib) ---
@ignis_export("wordcount")
def wordcount(ctx, data=None, valid=None):
    vocab = int(ctx.var("vocab"))
    counts = torch.bincount(torch.where(valid, data, vocab).long(), minlength=vocab + 1)[:-1]
    keys = torch.arange(vocab, dtype=torch.int32, device=data.device)
    return {"key": keys, "value": counts.to(torch.int32)}, counts > 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--p", type=int, default=8, help="virtual executor ranks")
    args = ap.parse_args()

    Ignis.start()
    cluster = ICluster(IProperties({"ignis.device": args.device,
                                    "ignis.executor.instances": str(args.p)}))
    worker = IWorker(cluster, "python")

    with tempfile.TemporaryDirectory() as tmp:
        # Task 1+2 (dataflow): corpus → tokens
        corpus_path = os.path.join(tmp, "quickstart.txt")
        with open(corpus_path, "w") as f:
            f.write("\n".join(synthetic_corpus(50, 40)))
        words = worker.text_file(corpus_path, as_tokens=True)
        vocab = len(worker._text_vocab)

        # Task 3 (native SPMD): wordcount over the shared ranks
        worker.load_library("repro_torch.apps.minebench")  # (library loading demo)
        counts = worker.call("wordcount", words, vocab=vocab)

        # Task 4 (dataflow): save as json
        out = os.path.join(tmp, "quickstart_counts.json")
        counts.save_as_json_file(out)
        with open(out) as f:
            total = sum(r["value"] for r in json.load(f))
    n_tokens = words.count()
    print(f"wordcount: {vocab} distinct words, {total} total (tokens={n_tokens})")
    assert total == n_tokens
    Ignis.stop()
    print("OK")


if __name__ == "__main__":
    main()
