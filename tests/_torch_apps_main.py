"""The JAX side of the p = 8 checks of tests/test_torch_comm_plans.py and
tests/test_torch_apps.py.

Runs tests/_torch_apps_cases.py's ``comm_script`` on the world of 8 fake
XLA host devices and on a group of its first 4, and ``spmd_apps`` (the
stencil and CG natively and through ``worker.call``), and writes the
results to the ``.npz`` named on the command line. The tests start it in a
subprocess, so the 8-device flag never reaches the pytest process.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import json  # noqa: E402

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_apps_cases as cases  # noqa: E402
import jax  # noqa: E402

import repro.core as core  # noqa: E402
from repro.apps import stencil  # noqa: E402
from repro.core import comm  # noqa: E402


def main(out_path: str):
    assert len(jax.devices()) == 8, jax.devices()
    w = core.IWorker(core.ICluster(core.IProperties(
        {"ignis.executor.instances": "8"})), "cpp")
    w.load_library("repro.apps.stencil")
    arrays, steps = {}, {}
    for name, ctx in (("world", w.context), ("group", w.context.group(range(4)))):
        comm.engine().clear()
        rows = cases.comm_script(comm, ctx, lambda a, c=ctx: comm.shard_rows(c, a),
                                 np.asarray)
        steps[name] = [(s, d) for s, _v, d in rows]
        for i, (s, v, _d) in enumerate(rows):
            if v is not None:
                arrays[f"{name}|{i}"] = v

    def call(app, x, iters):
        blk = w.call(app, w.parallelize(x), iters=iters)._blocks()[0]
        return np.asarray(blk.data)

    out, _g, _b = cases.spmd_apps(
        stencil, w.context.comm(), 8, lambda a: comm.shard_rows(w.context, a),
        np.asarray, call)
    arrays.update({f"app|{k}": v for k, v in out.items()})
    np.savez(out_path, steps=np.asarray(json.dumps(steps)), **arrays)
    print("TORCH_APPS_JAX_OK")


if __name__ == "__main__":
    main(sys.argv[1])
