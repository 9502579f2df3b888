"""The readings that the limits of ``correct`` are set from, on the chip at
a cell's own size (no result line; the benchmark's runs never call this):

    python3 chipbench/calibrate.py --workload <name> --seeds 1,2,... \\
        [--control 1,2,3] [--fault 1,2,3] [--seconds 20] [--out file.jsonl]

For each seed, in one process: the program's numbers (its first steps or
its served requests against the reference). For a ``--control`` seed: the
control's, the reference computed with fp8 products put in the program's
place (a served model's control reads, at each position of the same
prompts and tokens, the gap of the token the fp8 forward puts first). For
a ``--fault`` seed of a training cell: the program's numbers with half of
each batch left out, the mean taken over the rest, planted in the program.
Each reading is a JSON line.
"""
import argparse
import contextlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@contextlib.contextmanager
def half_batch():
    """The program's train step given the first half of each batch."""
    from repro_torch.launch import train as launch_train

    orig = launch_train.make_train_step

    def make(*a, **kw):
        step = orig(*a, **kw)

        def half(params, opt, ef, batch):
            return step(params, opt, ef, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
        return half

    launch_train.make_train_step = make
    try:
        yield
    finally:
        launch_train.make_train_step = orig


def train_readings(cell, seed, device, control, fault, emit):
    from chipbench import compare, program
    from chipbench.drivers import train as D

    def program_side():
        st = D.build(cell, seed, device)
        prog = D.first_steps(st)
        fed = st.fed
        st.pipe.close()
        del st
        program.free_cuda()
        return prog, fed

    prog, fed = program_side()
    ref, host = D.reference_steps(cell, seed, device)
    emit("program", seed, compare.train_numbers(prog, ref, D.mismatch(fed, host)))
    program.free_cuda()
    if control:
        ctl, _ = D.reference_steps(cell, seed, device, "fp8")
        emit("control", seed, compare.train_numbers(ctl, ref, 0))
        program.free_cuda()
    if fault:
        with half_batch():
            prog, fed = program_side()
        emit("half_batch", seed, compare.train_numbers(prog, ref, D.mismatch(fed, host)))


def serve_readings(cell, seed, device, control, seconds, emit):
    from chipbench import common, program
    from chipbench.drivers import serve as D

    out = common.Outcome(cell.config, cell.traffic, common.Spans(), common.now())
    st = D.build(cell, seed, device, out.spans, False)
    D.window(st, seconds, False, out)
    done = D.finished(st)
    del st
    program.free_cuda()
    reqs = D.sample(done, seed, cell.traffic["check"])
    gaps = D.reference_gaps(cell, seed, device, reqs)
    emit("program", seed, {"max_gap": max(max(g) for g in gaps if g),
                           "length_mismatch": sum(len(t) != n for _, t, n in reqs),
                           "_sampled_tokens": sum(len(g) for g in gaps),
                           "_attempted": out.attempted, "_failed": out.failed})
    if control:
        gaps = D.reference_gaps(cell, seed, device, reqs, "fp8")
        emit("control", seed, {"max_gap": max(max(g) for g in gaps if g)})
    program.free_cuda()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)

    from chipbench import common

    common.process_env()
    from chipbench import registry
    from chipbench.reference.precision import strict_f32

    strict_f32()
    cell = registry.cell(a.workload)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    control, fault = set(ints(a.control)), set(ints(a.fault))
    sink = open(a.out, "a") if a.out else None

    def emit(kind, seed, numbers):
        line = json.dumps({"workload": cell.name, "kind": kind, "seed": seed,
                           "numbers": numbers, "t": time.time()})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    for seed in ints(a.seeds):
        if cell.traffic["kind"] == "train":
            train_readings(cell, seed, "cuda", seed in control, seed in fault, emit)
        else:
            serve_readings(cell, seed, "cuda", seed in control, a.seconds, emit)
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
