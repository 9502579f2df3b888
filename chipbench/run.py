"""Run one cell of the benchmark once, on the machine this is started on:

    python3 chipbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (JSON); the last lines of standard error are the numbers that
decided ``correct``, each beside its limit. Exits non-zero, printing no
result, where there is no CUDA card (or fewer than the cell asks for),
where the program under test (``src/repro_torch``) is not in this checkout,
or where the JAX package or JAX was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def fail(msg: str, code: int) -> int:
    print(f"chipbench: {msg}", file=sys.stderr)
    return code


def power_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,"
                            "clocks.max.sm,temperature.gpu",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=60)
        return r.stdout.strip().replace("\n", "; ") or "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    from chipbench import common, harness, registry

    common.process_env()
    try:
        cell = registry.cell(a.workload)
    except (OSError, KeyError) as e:
        return fail(f"cannot read workload {a.workload!r}: {e}", 2)
    try:
        import repro_torch
    except ImportError as e:
        return fail(f"the program under test is not in this checkout: {e}", 2)
    if not pathlib.Path(repro_torch.__file__).resolve().is_relative_to(ROOT / "src"):
        return fail(f"repro_torch comes from {repro_torch.__file__}, not this checkout", 2)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        return fail(f"{cell.name} needs {cell.chips} CUDA card(s); torch sees "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", 3)

    res = harness.run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda", T_START,
                           chips=cell.chips)
    bad = common.forbidden_loaded()
    if bad:
        return fail(f"modules loaded that the benchmark may not load: {bad}", 4)
    print(f"chipbench: card {power_line()}", file=sys.stderr)
    print(f"chipbench: window spans (s): {json.dumps(res['spans'])}", file=sys.stderr)
    print(f"chipbench: {cell.name} seed {a.seed}: {json.dumps(res['numbers'])}",
          file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(common.result_line(res["correct"], res["attempted"], res["failed"], res["metrics"],
                             res["device"], res["checks"], res["breakdown"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
