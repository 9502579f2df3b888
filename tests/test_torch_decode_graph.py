"""The serve engine's batched decode as a CUDA graph (``serving/engine.py``).

On the CPU: the rule that decides when a decode is graphed (a CUDA device
and a decode that writes its cache in place) on the transformer's, the
hybrid's and the SSM's caches; a CPU engine that never captures; the
launch counters a capture takes back and each replay credits. The tests
marked ``cuda`` run the engine on a card and skip without one (``pytest
-m cuda tests/test_torch_decode_graph.py`` on the card): a graphed engine
serves bit for bit what an eager one serves and leaves the same slab, with
the same decode kernel launches a tick, also with each tick on a thread of
its own; a hybrid stays eager; a decode that synchronises falls back
cleanly.
"""
import dataclasses
import os
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention.decode_attention import decode_attention_fwd
from repro_torch.models import build_model
from repro_torch.profile import spans
from repro_torch.serving.engine import Request, ServeEngine, why_not_graphed

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from chip_smoke import _not_in_place  # noqa: E402

CUDA = torch.device("cuda")


def _decoded(arch, slots=2, cache_len=16):
    """A reduced ``arch`` on the CPU: the slab it was given and the cache
    one decode step returned."""
    cfg = get_config(arch).reduced()
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(0))
    given = bundle.make_cache(slots, cache_len, device="cpu")
    toks = torch.zeros((slots, 1), dtype=torch.int32)
    _, returned = bundle.decode_step(params, given, toks)
    return given, returned


@pytest.mark.parametrize("arch,new", [("olmo-1b", None), ("qwen3-14b", None),
                                      ("mixtral-8x7b", None),
                                      ("mamba2-780m", "state"),
                                      ("jamba-1.5-large-398b", "conv, state")])
def test_only_an_in_place_decode_on_cuda_is_graphed(arch, new):
    given, returned = _decoded(arch)
    why = why_not_graphed(CUDA, given, returned)
    if new is None:
        assert why is None
        assert returned["k"] is given["k"] and returned["pos"] is not given["pos"]
    else:
        assert why is not None and new in why and "not in place" in why
    assert "cpu" in why_not_graphed(torch.device("cpu"), given, returned)


def test_a_decode_that_drops_or_adds_a_leaf_is_not_graphed():
    given, returned = _decoded("olmo-1b")
    assert "leaves" in why_not_graphed(CUDA, given, {**returned, "extra": returned["k"]})
    assert "leaves" in why_not_graphed(CUDA, given, {"pos": returned["pos"]})


def _requests(n, vocab, seed=0, lo=3, hi=12):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, vocab, int(rng.integers(4, 40))).astype(np.int32),
                    max_new_tokens=int(rng.integers(lo, hi))) for i in range(n)]


def test_a_cpu_engine_never_captures():
    cfg = get_config("olmo-1b").reduced()
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(0))
    eng = ServeEngine(bundle, params, slots=3, cache_len=64)
    for r in _requests(7, cfg.vocab_size):
        eng.submit(r)
    buf = spans.TraceBuffer()
    with spans.recording(buf):
        done = eng.run_to_completion()
    decodes = [s for s in buf.spans() if s.name == "engine.decode"]
    rec = eng.decode_graph
    assert len(done) == 7 and len(decodes) > 3
    assert (rec.captures, rec.replays, rec.eager) == (0, 0, len(decodes))
    assert "cpu" in rec.why_eager
    assert {s.args["graph"] for s in decodes} == {"eager"}


def test_a_capture_takes_its_launches_back_and_each_replay_credits_them():
    """Inside ``uncounted`` the thread's launches are taken aside (another
    thread's count as ever, and a block that raises still ends the taking);
    each ``credit_launches`` then counts them once."""
    fn = decode_attention_fwd
    n0, routes, geoms = fn.launches, dict(fn.launches_by_variant), set(fn.geometries)
    other = threading.Thread(target=kernels.count_launch, args=(fn, ((3,), 0), "whole"))
    try:
        with kernels.uncounted() as taken:
            for _ in range(3):
                kernels.count_launch(fn, ((1,), 0), "whole")
            kernels.count_launch(fn, ((2,), 0), "split")
            other.start()
            other.join()
        assert taken == {"decode_attention": (4, {"whole": 3, "split": 1})}
        assert fn.launches == n0 + 1
        assert fn.launches_by_variant == {**routes, "whole": routes.get("whole", 0) + 1}
        assert {((1,), 0), ((2,), 0), ((3,), 0)} <= fn.geometries
        for _ in range(2):
            kernels.credit_launches(taken)
        assert fn.launches == n0 + 9
        assert fn.launches_by_variant == {**routes, "whole": routes.get("whole", 0) + 7,
                                          "split": routes.get("split", 0) + 2}
        with pytest.raises(RuntimeError), kernels.uncounted():
            raise RuntimeError("a capture that fails")
        kernels.count_launch(fn, ((1,), 0))
        assert fn.launches == n0 + 10
    finally:
        fn.launches, fn.launches_by_variant, fn.geometries = n0, routes, geoms


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

SLOTS, CACHE_LEN = 8, 256


def _olmo(card, layers=2):
    """OLMo-1B at its widths, cut to ``layers`` layers, random bf16 weights
    on the card, the decode through the decode kernel."""
    cfg = get_config("olmo-1b").with_overrides(num_layers=layers, attn_impl="flash")
    bundle = build_model(cfg)
    return cfg, bundle, bundle.init(torch.Generator(device=card).manual_seed(0))


def _synchronising(decode_step):
    def step(params, cache, tokens):
        out = decode_step(params, cache, tokens)
        torch.cuda.synchronize()
        return out
    return step


class _Threads:
    """Runs each call on a thread of its own that stays alive until
    ``close``, holding the per-thread state the call made (its cuBLAS
    handle), so that the next call's thread has to make its own: a front
    door's tick may land on any of the scheduler's threads."""

    def __init__(self):
        self.release, self.threads = threading.Event(), []

    def call(self, fn):
        box, ran = {}, threading.Event()

        def body():
            try:
                box["out"] = fn()
            except BaseException as e:  # raised again on the caller's thread
                box["err"] = e
            ran.set()
            self.release.wait()

        t = threading.Thread(target=body, daemon=True)
        t.start()
        self.threads.append(t)
        assert ran.wait(300)
        if "err" in box:
            raise box["err"]
        return box.get("out")

    def close(self):
        self.release.set()
        for t in self.threads:
            t.join(60)
            assert not t.is_alive()


def _lockstep(a, b, reqs, call=lambda fn: fn()):
    """Submit copies of ``reqs`` to both engines and tick them in turns until
    both drain (``a``'s ticks through ``call``), holding their next tokens
    and slots equal after each tick; returns the ticks and the decode
    kernel's launches of each engine a tick."""
    for r in reqs:
        for eng in (a, b):
            eng.submit(Request(r.rid, r.prompt, max_new_tokens=r.max_new_tokens))
    launches = []
    while a.queue or any(a.live) or b.queue or any(b.live):
        n = []
        for eng in (a, b):
            n0 = decode_attention_fwd.launches
            call(eng.step) if eng is a else eng.step()
            n.append(decode_attention_fwd.launches - n0)
        launches.append(tuple(n))
        assert np.array_equal(a._last, b._last), f"tick {len(launches)}"
        assert [r and r.rid for r in a.live] == [r and r.rid for r in b.live]
        assert len(launches) < 1000
    for eng in (a, b):
        eng.retired.sort(key=lambda r: r.rid)
    assert [r.tokens for r in a.retired] == [r.tokens for r in b.retired]
    assert len(a.retired) == len(reqs)
    return len(launches), launches


@pytest.mark.cuda
def test_a_graphed_decode_serves_what_an_eager_one_serves(card):
    cfg, bundle, params = _olmo(card)
    graphed = ServeEngine(bundle, params, slots=SLOTS, cache_len=CACHE_LEN)
    eager = ServeEngine(bundle, params, slots=SLOTS, cache_len=CACHE_LEN)
    eager.bundle = dataclasses.replace(bundle, decode_step=_not_in_place(bundle.decode_step))
    reqs = _requests(24, cfg.vocab_size, seed=1, lo=2, hi=40)
    ticks, launches = _lockstep(graphed, eager, reqs)
    assert ticks >= 20
    assert all(na == nb for na, nb in launches)
    assert sum(na for na, _ in launches) == cfg.num_layers * (graphed.decode_graph.replays
                                                              + graphed.decode_graph.eager)
    for k in ("k", "v", "pos"):
        assert torch.equal(graphed.cache[k], eager.cache[k]), k
    g, e = graphed.decode_graph, eager.decode_graph
    assert (g.captures, g.eager, g.why_eager) == (1, 1, None) and g.replays >= 19
    assert (e.captures, e.replays) == (0, 0) and e.eager == g.eager + g.replays
    assert "for k, v:" in e.why_eager


@pytest.mark.cuda
def test_ticks_on_other_threads_capture_and_replay(card):
    """Each tick of the graphed engine on a new thread that keeps its cuBLAS
    handle: the capture runs on the thread of the eager decode that made
    one (a capture cannot create it), the replays on threads that never
    ran the decode."""
    cfg, bundle, params = _olmo(card)
    graphed = ServeEngine(bundle, params, slots=SLOTS, cache_len=CACHE_LEN)
    eager = ServeEngine(bundle, params, slots=SLOTS, cache_len=CACHE_LEN)
    eager.bundle = dataclasses.replace(bundle, decode_step=_not_in_place(bundle.decode_step))
    threads = _Threads()
    try:
        ticks, launches = _lockstep(graphed, eager, _requests(10, cfg.vocab_size, seed=4),
                                    call=threads.call)
    finally:
        threads.close()
    assert all(na == nb for na, nb in launches)
    for k in ("k", "v", "pos"):
        assert torch.equal(graphed.cache[k], eager.cache[k]), k
    g = graphed.decode_graph
    assert (g.captures, g.eager, g.why_eager) == (1, 1, None) and g.replays == ticks - 1


@pytest.mark.cuda
def test_a_synchronising_decode_falls_back_cleanly(card):
    cfg, bundle, params = _olmo(card)
    syncing = ServeEngine(bundle, params, slots=SLOTS, cache_len=CACHE_LEN)
    syncing.bundle = dataclasses.replace(bundle,
                                         decode_step=_synchronising(bundle.decode_step))
    eager = ServeEngine(bundle, params, slots=SLOTS, cache_len=CACHE_LEN)
    eager.bundle = dataclasses.replace(bundle, decode_step=_not_in_place(bundle.decode_step))
    ticks, launches = _lockstep(syncing, eager, _requests(12, cfg.vocab_size, seed=2))
    assert all(na == nb for na, nb in launches)
    for k in ("k", "v", "pos"):
        assert torch.equal(syncing.cache[k], eager.cache[k]), k
    rec = syncing.decode_graph
    assert (rec.captures, rec.replays) == (0, 0) and rec.eager == eager.decode_graph.eager
    assert rec.why_eager.startswith("the capture raised")
    assert torch.cuda.current_stream(card) == torch.cuda.default_stream(card)


@pytest.mark.cuda
def test_a_hybrid_engine_stays_eager(card):
    cfg = get_config("jamba-1.5-large-398b").reduced()
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device=card).manual_seed(0))
    eng = ServeEngine(bundle, params, slots=4, cache_len=128)
    for r in _requests(6, cfg.vocab_size, seed=3):
        eng.submit(r)
    done = eng.run_to_completion()
    rec = eng.decode_graph
    assert len(done) == 6 and rec.eager > 3
    assert (rec.captures, rec.replays) == (0, 0)
    assert "conv, state" in rec.why_eager
