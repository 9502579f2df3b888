"""Running native HPC (SPMD/"MPI") applications inside the framework —
the paper's §5 (LULESH example, Figs. 9–11) — on the PyTorch port.

The stencil and CG proxy apps are plain collective programs over the
worker's ranks; the framework integration is the @ignis_export wrapper +
context argument parsing (the paper's +17…75 SLOC). This driver runs both
through worker.call and checks the result matches executing them natively.

Run:  PYTHONPATH=src python examples/torch_native_hpc_app.py               # on the card
      PYTHONPATH=src python examples/torch_native_hpc_app.py --device cpu
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.apps.stencil import cg_native, laplacian_matvec_ref, stencil_native  # noqa: E402
from repro_torch.core import Ignis, ICluster, IProperties, IWorker  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--p", type=int, default=8, help="virtual executor ranks")
    args = ap.parse_args()

    Ignis.start()
    cluster = ICluster(IProperties({"ignis.device": args.device,
                                    "ignis.executor.instances": str(args.p)}))
    worker = IWorker(cluster, "cpp")  # the paper's C++ worker
    worker.load_library("repro_torch.apps.stencil")

    ranks, axis = worker.context.comm()

    # ---- stencil (LULESH/miniAMR analogue) --------------------------------
    grid = np.random.default_rng(0).normal(size=(32, 16)).astype(np.float32)
    out_fw = worker.call("stencil_app", worker.parallelize(grid), iters=8)
    got = np.stack([np.asarray(r) for r in out_fw.collect()])
    native = stencil_native(ranks, axis, torch.from_numpy(grid).to(cluster.device), 8)
    print("stencil framework==native:", np.array_equal(got, native.cpu().numpy()))
    assert np.array_equal(got, native.cpu().numpy())

    # ---- CG solver (AMG analogue) ------------------------------------------
    b = np.random.default_rng(1).normal(size=128).astype(np.float32)
    x_df = worker.call("cg_app", worker.parallelize(b), iters=200)
    x = torch.tensor(np.stack([np.asarray(r) for r in x_df.collect()]))
    res = float((laplacian_matvec_ref(x) - torch.from_numpy(b)).abs().max())
    print(f"CG residual: {res:.2e}")
    assert res < 1e-3
    x_nat = cg_native(ranks, axis, torch.from_numpy(b).to(cluster.device), 200)
    assert np.array_equal(x.numpy(), x_nat.cpu().numpy())

    Ignis.stop()
    print("OK")


if __name__ == "__main__":
    main()
