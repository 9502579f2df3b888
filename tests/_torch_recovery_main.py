"""The JAX side of the p = 8 checks of tests/test_torch_faults.py,
tests/test_torch_elastic.py and tests/test_torch_streaming.py.

Runs one group of tests/_torch_recovery_cases.py (``faults``, ``elastic``
or ``streaming``) on 8 fake XLA host devices and writes each case's record
as JSON to the path named on the command line. The tests start it in a
subprocess, so the 8-device flag never reaches the pytest process:

    python tests/_torch_recovery_main.py faults /tmp/faults.json
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import json  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_recovery_cases as cases  # noqa: E402
import jax  # noqa: E402


def main(group: str, out_path: str):
    assert len(jax.devices()) == 8, jax.devices()
    out = cases.run_group(cases.Pkg("jax", 8), group, 8)
    with open(out_path, "w") as f:
        json.dump(out, f, default=repr)
    print("TORCH_RECOVERY_JAX_OK", group, len(out))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
