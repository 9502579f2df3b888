"""One scheduled job across programming models (paper §3.2, Figs. 2–3, 12)
on the PyTorch port.

The quickstart runs the hybrid wordcount eagerly, one action at a time.
This driver submits TWO independent branches into a single ``IJob``:

  * branch A (dataflow → native → dataflow): tokens resharded to an SPMD
    worker via importData, counted by a native wordcount app, collected;
  * branch B (pure dataflow): line-length histogram on the original worker.

The scheduler cuts each lineage at task boundaries (stage / native /
reshard / action), deduplicates shared subgraphs, and overlaps the
branches across the two workers — ``job.explain()`` shows the scheduled
cross-worker DAG (docs/driver.md).

Run:  PYTHONPATH=src python examples/torch_hybrid_job.py               # on the card
      PYTHONPATH=src python examples/torch_hybrid_job.py --device cpu
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import Ignis, ICluster, IProperties, IWorker  # noqa: E402
from repro_torch.core.native import ignis_export  # noqa: E402
from repro_torch.data.synthetic import synthetic_corpus  # noqa: E402


@ignis_export("wordcount_spmd")
def wordcount_spmd(ctx, data=None, valid=None):
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
    dataflow = IWorker(cluster, "python")
    spmd = IWorker(cluster, "spmd")

    with tempfile.TemporaryDirectory() as tmp:
        corpus_path = os.path.join(tmp, "hybrid_job.txt")
        with open(corpus_path, "w") as f:
            f.write("\n".join(synthetic_corpus(60, 30)))

        # branch A: dataflow tokens → importData reshard → native SPMD wordcount
        words = dataflow.text_file(corpus_path, as_tokens=True)
        vocab = len(dataflow._text_vocab)
        counts = spmd.call("wordcount_spmd", spmd.import_data(words), vocab=vocab)

        # branch B: independent dataflow histogram of line lengths
        lens = dataflow.text_file(corpus_path).map(lambda r: r[1] % 16)

        job = Ignis.job("hybrid-wordcount")
        f_counts = counts.collect_async(job=job)
        f_hist = lens.count_by_value_async(job=job)
        f_tokens = words.count_async(job=job)
        rows, hist, n_tokens = f_counts.result(), f_hist.result(), f_tokens.result()

    total = sum(int(np.asarray(r["value"])) for r in rows)
    print(job.explain())
    st = job.stats()
    print(
        f"job stats: {st['tasks']} tasks "
        f"({st['native']} native, {st['reshard']} reshard, {st['stage']} stage, "
        f"{st['actions']} actions) on workers {st['workers']}"
    )
    print(f"wordcount: {vocab} distinct words, {total} total (tokens={n_tokens})")
    print(f"line-length histogram buckets: {len(hist)}")
    assert total == n_tokens
    assert st["failed"] == 0 and st["native"] == 1 and st["reshard"] >= 1
    Ignis.stop()
    print("OK")


if __name__ == "__main__":
    main()
