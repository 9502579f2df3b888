"""The JAX side of the p = 8 checks of tests/test_torch_profile.py and
tests/test_torch_cost.py.

On 8 fake XLA host devices: tests/_torch_profile_cases.py's
``two_gang_job`` on the JAX package, and the compiled HLO text of an 8-way
``psum`` (one device in the test process cannot lower it). Writes both to
the JSON file named on the command line. The tests start it in a
subprocess, so the 8-device flag never reaches the pytest process.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import json  # noqa: E402

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_profile_cases as cases  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.shard_map import shard_map  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

import repro.core as core  # noqa: E402
import repro.profile as profile  # noqa: E402


def main(out_path: str):
    assert len(jax.devices()) == 8, jax.devices()
    gang = cases.two_gang_job(core, profile, {"ignis.executor.instances": "8"})
    mesh = Mesh(np.array(jax.devices()), ("data",))
    g = shard_map(lambda x: jax.lax.psum(x * 2.0, "data"),
                  mesh=mesh, in_specs=P("data"), out_specs=P())
    psum = jax.jit(g).lower(jnp.ones((8, 16), jnp.float32)).compile().as_text()
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump({"gang": gang, "psum_hlo": psum}, f)
    print("TORCH_PROFILE_JAX_OK")


if __name__ == "__main__":
    main(sys.argv[1])
