"""The JAX side of tests/test_torch_dryrun.py's per-rank argument bytes.

For each case (arch, kind, batch, seq, mesh shape, sharding preset) of the
JSON list named on the command line: the JAX bundle's ``step_for_cell`` of
the reduced config under that preset, its arguments' specs from the JAX
package's ``param_specs``, ``opt_specs``, ``input_specs_sharding`` and
``cache_specs`` through ``to_named``, as the JAX dry run builds them,
lowered and compiled with ``jax.jit`` on 8 fake host devices. Writes
``{case: argument_size_in_bytes}`` of XLA's memory analysis to the JSON
file named second. The test starts it in a subprocess, so the 8-device
flag never reaches the pytest process:

    python tests/_torch_dryrun_main.py cases.json out.json
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import json  # noqa: E402

import jax  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import ShapeCell  # noqa: E402
from repro.core import compat  # noqa: E402
from repro.distributed.sharding import (  # noqa: E402
    cache_specs,
    input_specs_sharding,
    opt_specs,
    param_specs,
    to_named,
)
from repro.models import build_model  # noqa: E402


def argument_bytes(arch, kind, B, S, shape, preset) -> int:
    cfg = get_config(arch).reduced().with_overrides(sharding_preset=preset)
    cell = ShapeCell("case", S, B, kind)
    mesh = compat.make_mesh(tuple(shape), ("data", "model"))
    fn, args = build_model(cfg).step_for_cell(cell)
    if kind == "train":
        params_av, opt_av, batch_av = args
        psp = param_specs(params_av, cfg, mesh)
        in_sh = (to_named(psp, mesh), to_named(opt_specs(opt_av, psp, cfg, mesh), mesh),
                 to_named(input_specs_sharding(batch_av, cfg, mesh), mesh))
        donate = (0, 1)
    elif kind == "prefill":
        params_av, inp_av = args
        psp = param_specs(params_av, cfg, mesh)
        in_sh = (to_named(psp, mesh), to_named(input_specs_sharding(inp_av, cfg, mesh), mesh))
        donate = ()
    else:
        params_av, cache_av, tok_av = args
        psp = param_specs(params_av, cfg, mesh)
        tok_sh = input_specs_sharding({"tokens": tok_av}, cfg, mesh)["tokens"]
        in_sh = (to_named(psp, mesh), to_named(cache_specs(cache_av, cfg, mesh), mesh),
                 to_named(tok_sh, mesh))
        donate = (1,)
    with compat.set_mesh(mesh):
        compiled = jax.jit(fn, in_shardings=in_sh, donate_argnums=donate).lower(*args).compile()
    return int(compiled.memory_analysis().argument_size_in_bytes)


def main(cases_path, out_path):
    with open(cases_path) as f:
        cases = json.load(f)
    out = {c["id"]: argument_bytes(c["arch"], c["kind"], c["batch"], c["seq"], c["mesh"],
                                   c["preset"])
           for c in cases}
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
