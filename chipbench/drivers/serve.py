"""The serving window: a closed loop of clients against
``streaming.ServeFrontDoor`` over ``serving.ServeEngine`` on a cuda
``IWorker``, each tick an ``IJob`` task of the scheduler.

Set-up submits the first request of every client (their budgets are what
remains of requests already under way, so retirements are spread from the
first tick on), and ticks ``warm_ticks`` times, which admits and prefills
them all. In the window the benchmark ticks (``tick_async().result()``)
until ``--seconds`` have passed (and, where the mix sets ``min_retired``,
as the reduced mixes of the CPU tests do, until that many requests have
retired in the window, within ``WORK_CAP_S``); after each tick, every
client whose request retired submits its next one, and a request holding
its first token is stamped with the tick's end. ``serve_tokens_per_s`` is
the tokens served by the window's ticks over the window; ``ttft_p95_ms``
the 95th percentile of submit-to-first-token over every request submitted
in it. A shed request, or one without a token at the close, counts as
failed and as missing any limit; only a shed one is lost. With
``--trace 1`` the engine's prefill calls are timed (synchronised to the
device) and ticks ``TRACED_TICKS`` are traced.
"""
from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace

from chipbench import common, compare, program
from chipbench import traffic as T
from chipbench import weights as W
from chipbench.registry import reference_module

TRACED_TICKS = (4, 16)
WORK_CAP_S = 120.0  # the most a window waits past --seconds for ``min_retired``


def build(cell, seed: int, device: str, spans, trace: bool):
    import torch
    from repro_torch.core import ICluster, IJob, IProperties, IWorker
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    from repro_torch.streaming import ServeFrontDoor

    conf, mix = cell.config, cell.traffic
    specs = reference_module(conf).param_specs(conf["sizes"])
    cfg = program.config(conf)
    params = program.model(cfg, W.make(specs, seed, device))
    bundle = build_model(cfg)
    engine = ServeEngine(bundle, params, slots=mix["slots"], cache_len=mix["cache_len"])
    traced = common.TracedWindow(trace and device.startswith("cuda"), *TRACED_TICKS)
    if trace:
        engine.bundle = dataclasses.replace(
            bundle, prefill=_timed_prefill(bundle.prefill, traced, spans, device))
    props = IProperties({"ignis.device": device,
                         "ignis.serve.queue.depth": str(mix["queue_depth"])})
    worker = IWorker(ICluster(props), "python")
    fd = ServeFrontDoor(engine, worker, job=IJob("chipbench.serve"))
    return SimpleNamespace(torch=torch, cell=cell, device=device, fd=fd, traced=traced,
                           requests=T.requests(mix, seed, conf["sizes"]["vocab_size"]),
                           next=0, tickets=[])


def _timed_prefill(prefill, traced, spans, device):
    def timed(params, **kw):
        t0 = common.now()
        out = prefill(params, **kw)
        if device.startswith("cuda"):
            import torch

            torch.cuda.synchronize()
        spans.add("prefill", common.now() - t0, tokens=int(kw["tokens"].shape[1]),
                  traced=traced.active)
        return out
    return timed


def submit(st):
    """The next request of the traffic, from a client whose last one
    retired."""
    prompt, new = st.requests[st.next % len(st.requests)]
    st.next += 1
    tk = st.fd.submit(prompt, max_new_tokens=int(new))
    st.tickets.append(tk)
    return tk


def served(st) -> int:
    return sum(len(t.request.tokens) for t in st.tickets if not t.shed)


def window(st, seconds: float, trace: bool, out) -> None:
    torch, spans, mix = st.torch, out.spans, st.cell.traffic
    cuda = st.device.startswith("cuda")
    for _ in range(mix["clients"]):
        submit(st)
    for _ in range(mix["warm_ticks"]):
        for _ in st.fd.tick_async().result():
            submit(st)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    out.metrics["setup_s"] = common.now() - out.t_start
    spans.spans.pop("prefill", None)  # set-up's prefills are not the window's
    before = served(st)
    ttft, pending = [], []
    n = done = 0
    t0 = common.now()
    while True:
        st.traced.before(n)
        ts = common.now()
        retired = st.fd.tick_async().result()
        te = common.now()
        spans.add("tick", te - ts, traced=st.traced.active)
        st.traced.after(n, out)
        n += 1
        done += len(retired)
        for tk in pending[:]:
            if tk.request.tokens:
                ttft.append(te - tk.t_submit)
                pending.remove(tk)
        if te - t0 >= seconds and (done >= mix.get("min_retired", 0)
                                   or te - t0 >= seconds + WORK_CAP_S):
            break
        for _ in retired:
            tk = submit(st)
            if tk.shed:
                ttft.append(math.inf)
            else:
                pending.append(tk)
    st.traced.close(out)
    ttft += [math.inf] * len(pending)
    out.attempted = len(ttft)
    out.failed = sum(not math.isfinite(x) for x in ttft)
    out.lost = out.failed - len(pending)
    out.metrics["serve_tokens_per_s"] = (served(st) - before) / (te - t0)
    if ttft:
        out.metrics["ttft_p95_ms"] = common.percentile(ttft, 95) * 1e3
    out.memory_peak = torch.cuda.max_memory_allocated() if cuda else 0


def finished(st) -> list:
    """(prompt, served tokens, tokens asked for) of every request retired."""
    return [(t.request.prompt, list(t.request.tokens), t.request.max_new_tokens)
            for t in st.tickets if not t.shed and t.done()]


def sample(done: list, seed: int, check: dict) -> list:
    """The longest finished request, then others drawn from the seed, until
    ``min_tokens`` served tokens or ``max_requests`` requests."""
    import numpy as np

    if not done:
        return []
    order = sorted(range(len(done)), key=lambda i: (-len(done[i][1]), -len(done[i][0]), i))
    first, rest = order[0], order[1:]
    rng = np.random.default_rng(common.seed_of(seed, "sample"))
    picked, tokens = [first], len(done[first][1])
    for i in rng.permutation(len(rest)):
        if tokens >= check["min_tokens"] or len(picked) >= check["max_requests"]:
            break
        picked.append(rest[i])
        tokens += len(done[rest[i]][1])
    return [done[i] for i in picked]


def reference_gaps(cell, seed: int, device: str, reqs: list, mode: str = "f32") -> list:
    """Per sampled request, each served token's gap below the reference's
    best logit; under ``mode="fp8"`` (the control), the gap of the token
    that the fp8 forward puts first at each position instead."""
    import torch

    conf = cell.config
    ref = reference_module(conf)
    w = {k: v.float() for k, v in W.make(ref.param_specs(conf["sizes"]), seed, device).items()}
    gaps = []
    for prompt, toks, _ in reqs:
        seq = torch.as_tensor(list(prompt) + toks[:-1], device=device)[None]
        logits = ref.logits(w, seq, conf["sizes"], "f32", start=len(prompt) - 1)
        if mode == "f32":
            chosen = toks
        else:
            chosen = ref.logits(w, seq, conf["sizes"], mode, start=len(prompt) - 1).argmax(-1)
        gaps.append(compare.token_gaps(logits, chosen))
        del logits
    return gaps


def run(cell, seed: int, seconds: float, trace: bool, device: str, out):
    st = build(cell, seed, device, out.spans, trace)
    window(st, seconds, trace, out)
    done = finished(st)
    del st
    program.free_cuda()
    from chipbench.reference.precision import strict_f32

    strict_f32()
    reqs = sample(done, seed, cell.traffic["check"])
    gaps = reference_gaps(cell, seed, device, reqs)
    out.numbers = {
        "length_mismatch": float(sum(len(t) != n for _, t, n in reqs)),
        "max_gap": max((max(g) for g in gaps if g), default=math.inf),
        "_sampled_requests": len(reqs), "_sampled_tokens": sum(len(g) for g in gaps)}
    program.free_cuda()
