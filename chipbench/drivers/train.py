"""The training window: ``launch.train.make_train_step``'s step on batches
that ``data.pipeline`` packs (``pack_sequences``), orders
(``batches_from_rows``) and feeds (``TrainPipeline``).

Set-up builds the one training object (weights from the seed, AdamW's
state, the step function and the feed) and drives it through its first
``checked_steps`` steps, which warm every shape up and are what the
reference follows; the window takes that same object on. The window runs
whole steps until ``--seconds`` have passed, reading each step's loss as a
loop that logs every step does; the mix's ``rate_metric`` is the tokens of
those steps over the time from the first step's start to the last one's
end. With ``--trace 1`` the window's second and third steps are traced.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

from chipbench import common, compare, program
from chipbench import traffic as T
from chipbench import weights as W
from chipbench.reference import train as RT
from chipbench.registry import reference_module

TRACED_STEPS = (1, 3)  # window steps [1, 3) are traced


def build(cell, seed: int, device: str):
    """The training object of a run, before its first step."""
    import torch
    from repro_torch.data.pipeline import TrainPipeline, batches_from_rows, pack_sequences
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build_model

    conf, mix = cell.config, cell.traffic
    specs = reference_module(conf).param_specs(conf["sizes"])
    cfg = program.config(conf)
    params = program.model(cfg, W.make(specs, seed, device))
    bundle = build_model(cfg)
    opt = bundle.init_opt(params)
    sched = mix["schedule"]
    step = launch_train.make_train_step(bundle, cfg, peak_lr=sched["peak_lr"],
                                        warmup=sched["warmup"], total=sched["total"])
    docs = T.documents(mix, seed, conf["sizes"]["vocab_size"])
    rows = pack_sequences(docs, mix["seq_len"])
    pipe = TrainPipeline(batches_from_rows(rows, mix["batch"], seed=common.seed_of(seed, "order")),
                         device=device)
    return SimpleNamespace(cell=cell, seed=seed, device=device, specs=specs, params=params,
                           opt=opt, ef=None, step=step, pipe=pipe, docs=docs, torch=torch)


def first_steps(st) -> dict:
    """The checked steps through the window's own call and feed: each
    step's loss, each leaf's first gradient as AdamW got it (its first
    moment after one step over 1 - b1) and its change after the last, as
    stored; the batches fed, kept for the comparison."""
    torch = st.torch
    losses, fed, g1 = [], [], None
    for i in range(st.cell.traffic["checked_steps"]):
        batch = next(st.pipe)
        fed.append({k: batch[k].cpu() for k in ("tokens", "labels")})
        st.params, st.opt, st.ef, loss = st.step(st.params, st.opt, st.ef, batch)
        losses.append(float(loss))
        if i == 0:
            m = st.opt["m"]
            g1 = dict(zip(m, (torch.stack([t.float().norm() for t in m.values()])
                              / (1 - RT.B1)).tolist()))
    p0 = W.make(st.specs, st.seed, st.device)
    with torch.no_grad():
        named = dict(st.params.named_parameters())
        change = dict(zip(named, torch.stack(
            [(p.float() - p0[k].float()).norm() for k, p in named.items()]).tolist()))
    del p0
    st.fed = fed
    return {"losses": losses, "grad_norms": g1, "change_norms": change}


def window(st, seconds: float, trace: bool, out) -> None:
    torch, mix, spans = st.torch, st.cell.traffic, out.spans
    cuda = st.device.startswith("cuda")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    traced = common.TracedWindow(trace and cuda, *TRACED_STEPS)
    n = failed = 0
    t0 = common.now()
    while True:
        traced.before(n)
        ts = common.now()
        batch = next(st.pipe)
        tf = common.now()
        st.params, st.opt, st.ef, loss = st.step(st.params, st.opt, st.ef, batch)
        failed += not math.isfinite(float(loss))
        te = common.now()
        spans.add("feed_wait", tf - ts, traced=traced.active)
        spans.add("step", te - ts, traced=traced.active)
        traced.after(n, out)
        n += 1
        if te - t0 >= seconds:
            break
    traced.close(out)
    out.metrics[mix["rate_metric"]] = n * mix["batch"] * mix["seq_len"] / (te - t0)
    out.attempted, out.failed, out.lost = n, failed, failed
    out.memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    st.pipe.close()


def reference_steps(cell, seed: int, device: str, mode: str = "f32") -> tuple:
    """The reference's first steps from the seed's weights and documents:
    (its readings, its batches as int64 host arrays)."""
    import torch

    conf, mix = cell.config, cell.traffic
    ref = reference_module(conf)
    specs = ref.param_specs(conf["sizes"])
    docs = T.documents(mix, seed, conf["sizes"]["vocab_size"])
    host = RT.batches(RT.pack(docs, mix["seq_len"], mix["format"]), mix["batch"],
                      common.seed_of(seed, "order"), mix["checked_steps"], mix["format"])
    dev = [{k: torch.as_tensor(v, device=device) for k, v in b.items()} for b in host]
    init = W.make(specs, seed, device)
    dtypes = {name: getattr(torch, dt) for name, _, dt, _ in specs}
    return RT.first_steps(ref, init, dtypes, dev, conf["sizes"], mix["schedule"], mode), host


def mismatch(fed: list, host: list) -> int:
    import numpy as np

    return int(sum(np.count_nonzero(f[k].numpy().astype(np.int64) != h[k])
                   for f, h in zip(fed, host) for k in ("tokens", "labels")))


def run(cell, seed: int, seconds: float, trace: bool, device: str, out):
    st = build(cell, seed, device)
    prog = first_steps(st)
    out.metrics["setup_s"] = common.now() - out.t_start
    window(st, seconds, trace, out)
    fed = st.fed
    del st
    program.free_cuda()
    from chipbench.reference.precision import strict_f32

    strict_f32()
    ref, host = reference_steps(cell, seed, device)
    out.numbers = compare.train_numbers(prog, ref, mismatch(fed, host))
    program.free_cuda()
