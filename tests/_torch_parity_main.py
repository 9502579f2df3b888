"""The JAX side of the p=8 parity check between ``repro`` and ``repro_torch``.

Runs every case of tests/_torch_parity_cases.py on 8 fake XLA host devices
under ``ignis.kernels`` off and interpret, and writes the rows, counters and
one capacity-padded reduced block to the ``.npz`` named on the command line.
tests/test_torch_slice.py drives it in a subprocess, so the 8-device flag
never reaches the pytest process.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import json  # noqa: E402

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_parity_cases as cases  # noqa: E402
import jax  # noqa: E402

import repro.core as core  # noqa: E402


def main(out_path: str):
    assert len(jax.devices()) == 8, jax.devices()
    ops = cases.jax_ops()
    results = {}
    for mode in ("off", "interpret"):
        for name in cases.CASES:
            results[f"{name}|{mode}"] = cases.run_case(name, core, ops, mode, 8)
    blocks = {f"{mode}_{k}": v
              for mode in ("off", "interpret")
              for k, v in cases.reduced_block_leaves(core, mode, 8).items()}
    np.savez(out_path, results=np.asarray(json.dumps(results)), **blocks)
    print("TORCH_PARITY_JAX_OK")


if __name__ == "__main__":
    main(sys.argv[1])
