"""Transitive Closure — the paper's driver example (Fig. 6), including the
two-worker (multi-programming-model) structure with importData between
them — on the PyTorch port.

Run:  PYTHONPATH=src python examples/torch_transitive_closure.py               # on the card
      PYTHONPATH=src python examples/torch_transitive_closure.py --device cpu
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.apps.graph import make_graph, tc_reference  # noqa: E402
from repro_torch.core import Ignis, ICluster, IProperties, IWorker  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--p", type=int, default=8, help="virtual executor ranks")
    args = ap.parse_args()

    # Initialization of the framework (Fig. 6 line 6)
    Ignis.start()
    prop = IProperties()
    prop["ignis.device"] = args.device
    prop["ignis.executor.instances"] = str(args.p)
    prop["ignis.executor.cores"] = "1"
    cluster = ICluster(prop)

    # Task 1: a Python worker tokenizes the edge list (paper Fig. 6 stores
    # them reversed and un-reverses in the joined map; we key by source)
    worker_a = IWorker(cluster, "python")
    edges_np = make_graph(16, 36, seed=7)
    tc = worker_a.parallelize(edges_np).map(lambda e: (e[0], e[1]))
    edges = tc.map(lambda e: {"key": e[0], "value": e[1]}).cache()

    # Task 2: a second worker (the paper's C++ worker) receives the data
    # through the inter-worker communicator (importData, paper Fig. 4)
    worker_b = IWorker(cluster, "cpp")
    tc2 = worker_b.import_data(tc).distinct().cache()
    edges_b = worker_b.import_data(edges).cache()

    old_count = 0
    next_count = tc2.count()
    while next_count != old_count:
        old_count = next_count
        lhs = tc2.map(lambda e: {"key": e[1], "value": e[0]})
        new_edges = lhs.join(edges_b, max_matches=8).map(
            lambda r: (r["value"][0], r["value"][1])
        )
        # compact() bounds capacity growth across fixed-point rounds
        tc2 = tc2.union(new_edges).distinct().compact().cache()
        next_count = tc2.count()

    print(f"TC has {next_count} edges")
    exp = tc_reference(edges_np)
    got = {(int(np.asarray(a)), int(np.asarray(b))) for a, b in tc2.collect()}
    assert got == exp, (len(got), len(exp))
    Ignis.stop()
    print("OK")


if __name__ == "__main__":
    main()
