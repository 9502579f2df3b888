"""The port's serve engine and ServeFrontDoor: the engine tests of
tests/test_serving.py in port form, the same requests through the JAX and
port engines on carried ``ignis-tiny`` weights, the front-door tests of
tests/test_streaming.py against a port worker (``ignis.device=cpu``), and
the CLI on the CPU.

Engine parity: logits of the two engines agree within LOGIT_TOL (f32 model
with the bf16 KV slab of both packages; they differ in summation order, under
1e-6 at these sizes), and a token is held equal where its row's top-2 margin
exceeds twice that, so equal tokens are not a tie's luck.
"""
import dataclasses
from collections import deque

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import ICluster, IJob, IProperties, IWorker  # noqa: E402
from repro_torch.interop import params_from_reference  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402
from repro_torch.streaming import ServeFrontDoor, StreamTelemetry  # noqa: E402

LOGIT_TOL = 1e-4


def _tiny(**over):
    cfg = get_config("ignis-tiny").with_overrides(**over)
    bundle = build_model(cfg)
    return cfg, bundle, bundle.init(torch.Generator().manual_seed(0))


def _greedy_reference(bundle, params, prompt, n_new):
    toks = torch.as_tensor(np.asarray(prompt, np.int32))[None]
    logits, cache = bundle.prefill(params, tokens=toks, cache_len=len(prompt) + n_new + 1)
    out = [int(torch.argmax(logits[0]))]
    for _ in range(n_new - 1):
        t = torch.tensor([[out[-1]]], dtype=torch.int32)
        logits, cache = bundle.decode_step(params, cache, t)
        out.append(int(torch.argmax(logits[0])))
    return out


# ---------------------------------------------------------------------------
# the engine (tests/test_serving.py in port form)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_engine_matches_single_request_greedy(impl):
    cfg, bundle, params = _tiny(attn_impl=impl)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(3, 9)), dtype=np.int32)
               for _ in range(5)]
    n_new = 6
    eng = ServeEngine(bundle, params, slots=2, cache_len=64)
    assert eng.cache["k"].device == torch.device("cpu") and eng.cache["k"].dtype == torch.bfloat16
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, max_new_tokens=n_new))
    done = eng.run_to_completion()
    assert len(done) == len(prompts)
    by_id = {r.rid: r.tokens for r in done}
    for i, p in enumerate(prompts):
        assert by_id[i] == _greedy_reference(bundle, params, p, n_new), i


def test_engine_slot_reuse_and_truncation():
    _, bundle, params = _tiny()
    eng = ServeEngine(bundle, params, slots=1, cache_len=32)
    for i in range(3):
        eng.submit(Request(i, np.asarray([1, 2, 3], np.int32), max_new_tokens=4))
    done = eng.run_to_completion()
    assert len(done) == 3  # one slot served all three sequentially
    assert all(len(r.tokens) == 4 for r in done)


def test_engine_single_tick_request_not_lost():
    _, bundle, params = _tiny()
    eng = ServeEngine(bundle, params, slots=2, cache_len=32)
    prompt = np.asarray([1, 2, 3], np.int32)
    for i in range(4):
        eng.submit(Request(i, prompt, max_new_tokens=1))
    done = eng.run_to_completion()
    assert sorted(r.rid for r in done) == [0, 1, 2, 3]
    assert all(len(r.tokens) == 1 and r.done for r in done)
    ref = _greedy_reference(bundle, params, prompt, 1)
    assert all(r.tokens == ref for r in done)


def test_engine_queue_is_deque_fifo():
    _, bundle, params = _tiny()
    eng = ServeEngine(bundle, params, slots=1, cache_len=32)
    assert isinstance(eng.queue, deque)
    for i in range(5):
        eng.submit(Request(i, np.asarray([7, i], np.int32), max_new_tokens=2))
    done = eng.run_to_completion()
    assert [r.rid for r in done] == [0, 1, 2, 3, 4]


def test_engine_eos_at_prefill_frees_slot():
    _, bundle, params = _tiny()
    prompt = np.asarray([1, 2, 3], np.int32)
    first = _greedy_reference(bundle, params, prompt, 1)[0]
    eng = ServeEngine(bundle, params, slots=1, cache_len=32)
    eng.submit(Request(0, prompt, max_new_tokens=8, eos_id=first))
    eng.submit(Request(1, prompt, max_new_tokens=2))
    eng._admit()
    assert [r.rid for r in eng.retired] == [0]
    assert eng.live[0] is not None and eng.live[0].rid == 1
    done = eng.run_to_completion()
    assert sorted(r.rid for r in done) == [0, 1]
    assert done[0].tokens == [first] and not done[0].truncated


def test_engine_with_ssm_family():
    """Continuous batching over an O(1)-state SSM: the reduced mamba2-780m
    (f32, as tests/test_serving.py serves it) gives the JAX engine's greedy
    tokens, each request's equal to its own greedy decode."""
    jb, jp, tb, tp, cfg = _carried("mamba2-780m", param_dtype="float32")
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab_size, 6, dtype=np.int32), 5) for _ in range(3)]
    tdone, held, total = _engines_agree(jb, jp, tb, tp, reqs, slots=2)
    assert held == total  # every row clears its margin: the tokens are all held
    for i, (p, n) in enumerate(reqs):
        assert tdone[i] == _greedy_reference(tb, tp, p, n)


def test_splice_pads_with_zeros_and_casts_to_the_slab():
    from repro_torch.serving.engine import _splice

    slab = {"k": torch.full((2, 3, 8, 1, 2), 7.0, dtype=torch.bfloat16),
            "pos": torch.zeros(3, dtype=torch.int32)}
    single = {"k": torch.full((2, 1, 5, 1, 2), 1.25, dtype=torch.float32),
              "pos": torch.tensor([5], dtype=torch.int32)}
    out = _splice(slab, single, 1, 8)
    assert out is slab and slab["k"].dtype == torch.bfloat16
    assert (slab["k"][:, 1, :5] == 1.25).all() and (slab["k"][:, 1, 5:] == 0).all()
    assert (slab["k"][:, 0] == 7).all() and (slab["k"][:, 2] == 7).all()
    assert slab["pos"].tolist() == [0, 5, 0]
    with pytest.raises(ValueError, match="cache_len"):
        _splice(slab, {"k": torch.zeros((2, 1, 9, 1, 2)), "pos": single["pos"]}, 0, 8)


def test_splice_copies_state_leaves_whole_into_their_slot():
    """An SSM cache's state (L, B, H, P, N) with H beyond cache_len, and its
    conv tail, are copied whole into the slot, as the JAX ``_splice`` does;
    the other slots stay as they were."""
    from repro.serving.engine import _splice as j_splice
    from repro_torch.serving.engine import _splice

    cfg = get_config("mamba2-780m").reduced().with_overrides(ssm_headdim=4)
    assert cfg.ssm_heads == 32 > 8  # H exceeds the slab's cache_len
    bundle = build_model(cfg)
    slab = bundle.make_cache(3, 8, device="cpu")
    slab["state"].fill_(7.0)
    rng = np.random.default_rng(0)
    single = {"conv": torch.from_numpy(rng.standard_normal((4, 1, 3, slab["conv"].shape[-1])))
              .float(),
              "state": torch.from_numpy(rng.standard_normal((4, 1, 32, 4, 16))).float(),
              "pos": torch.tensor([6], dtype=torch.int32)}
    want = j_splice({k: jnp.asarray(v.float().numpy(), str(v.dtype).split(".")[1])
                     for k, v in slab.items()},
                    {k: jnp.asarray(v.numpy()) for k, v in single.items()}, 1, 8)
    out = _splice(slab, single, 1, 8)
    assert out is slab and slab["conv"].dtype == torch.bfloat16
    assert torch.equal(slab["state"][:, 1], single["state"][:, 0])
    assert (slab["state"][:, 0] == 7).all() and (slab["state"][:, 2] == 7).all()
    assert torch.equal(slab["conv"][:, 1], single["conv"][:, 0].to(torch.bfloat16))
    assert slab["pos"].tolist() == [0, 6, 0]
    for k in slab:
        np.testing.assert_array_equal(slab[k].float().numpy(), np.asarray(want[k], np.float32))


# ---------------------------------------------------------------------------
# the same requests through both packages' engines
# ---------------------------------------------------------------------------


class _Recorder:
    """Wraps an engine's prefill and decode functions: keeps, by request id,
    the logits of each row whose token the engine uses (the prefill row,
    then the request's slot in each tick). Prefills run in submission order,
    so the n-th prefill is request n."""

    def __init__(self, engine, to_np):
        self.engine, self.to_np, self.rows = engine, to_np, {}

    def wrap_prefill(self, fn):
        def prefill(params, **kw):
            logits, cache = fn(params, **kw)
            self.rows[len(self.rows)] = [self.to_np(logits)[0]]
            return logits, cache
        return prefill

    def wrap_decode(self, fn):
        def decode(*a):
            logits, cache = fn(*a)
            arr = self.to_np(logits)
            for s, r in enumerate(self.engine.live):
                if r is not None:
                    self.rows[r.rid].append(arr[s])
            return logits, cache
        return decode


def _carried(name, reduced=True, **over):
    """(JAX bundle, JAX params, port bundle, port params, port config) of one
    architecture, the JAX weights carried across."""
    jcfg, cfg = j_config(name), get_config(name)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    jcfg, cfg = jcfg.with_overrides(**over), cfg.with_overrides(**over)
    jb, tb = j_build(jcfg), build_model(cfg)
    jp = jb.init(jax.random.PRNGKey(0))
    return jb, jp, tb, params_from_reference(jax.tree.map(np.asarray, jp), cfg), cfg


def _engines_agree(jb, jp, tb, tp, reqs, slots=3, cache_len=32, tol=LOGIT_TOL):
    """The same requests through both packages' engines. Every row the
    engines used agrees within ``tol``, request by request, up to the first
    near-tie (a top-2 margin of at most twice ``tol``) that the two packages
    broke differently: the rest of that request follows another token. A
    row whose margin clears twice ``tol`` must give both engines its token.
    Returns (the port's tokens by request id, rows whose token was held,
    rows in all)."""
    je = JServeEngine(jb, jp, slots=slots, cache_len=cache_len)
    jrec = _Recorder(je, lambda x: np.asarray(x, np.float32))
    je.bundle = dataclasses.replace(jb, prefill=jrec.wrap_prefill(jb.prefill))
    je._decode = jrec.wrap_decode(je._decode)
    te = ServeEngine(tb, tp, slots=slots, cache_len=cache_len)
    trec = _Recorder(te, lambda x: x.float().numpy())
    te.bundle = dataclasses.replace(tb, prefill=trec.wrap_prefill(tb.prefill),
                                    decode_step=trec.wrap_decode(tb.decode_step))
    for i, (p, n) in enumerate(reqs):
        je.submit(JRequest(i, p, max_new_tokens=n))
        te.submit(Request(i, p, max_new_tokens=n))
    jdone = {r.rid: r.tokens for r in je.run_to_completion()}
    tdone = {r.rid: r.tokens for r in te.run_to_completion()}
    assert sorted(tdone) == sorted(jdone) == list(range(len(reqs)))
    np.testing.assert_array_equal(np.asarray(te.cache["pos"]), np.asarray(je.cache["pos"]))
    held = total = 0
    for rid, (_p, n) in enumerate(reqs):
        jrows, trows = jrec.rows[rid], trec.rows[rid]
        assert len(jrows) == len(trows) == len(tdone[rid]) == len(jdone[rid]) == n
        total += n
        for step, (j, t) in enumerate(zip(jrows, trows)):
            assert np.abs(j - t).max() <= tol, (rid, step)
            top2 = np.sort(t)[-2:]
            if top2[1] - top2[0] > 2 * tol:
                assert tdone[rid][step] == jdone[rid][step], (rid, step)
                held += 1
            elif tdone[rid][step] != jdone[rid][step]:
                break
    return tdone, held, total


def _requests(seed, vocab, n=6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(3, 12)), dtype=np.int32),
             int(rng.integers(1, 7))) for _ in range(n)]


def test_port_engine_equals_the_jax_engine():
    jb, jp, tb, tp, cfg = _carried("ignis-tiny", reduced=False)
    _, held, total = _engines_agree(jb, jp, tb, tp, _requests(11, cfg.vocab_size))
    assert held == total


def test_port_engine_equals_the_jax_engine_on_the_moe_family():
    """The reduced mixtral-8x7b (f32; a 16-token sliding window, 4 experts
    top-2): prompts and decode ticks routed through the MoE router, over
    four request seeds. Held to 2e-3: a prefill key within the f32 noise
    (4e-7 here) of a bf16 rounding tie lands one ulp (2^-8) apart in the two
    packages' bf16 slabs, which moves a decode row by up to 1.3e-3. The
    small reduced vocabulary gives some rows a top-2 margin under twice
    that; their tokens are not held, and at least three rows in four must
    clear it (at least 14 of 17 over the request seeds 0-19)."""
    jb, jp, tb, tp, cfg = _carried("mixtral-8x7b", param_dtype="float32")
    for seed in range(4):
        _, held, total = _engines_agree(jb, jp, tb, tp, _requests(seed, cfg.vocab_size),
                                        tol=2e-3)
        assert held >= 0.75 * total, (seed, held, total)


# ---------------------------------------------------------------------------
# ServeFrontDoor (tests/test_streaming.py in port form)
# ---------------------------------------------------------------------------


@pytest.fixture
def worker():
    return IWorker(ICluster(IProperties({"ignis.device": "cpu"})), "python")


def _toy_engine(slots=2):
    """A deterministic stand-in for ServeEngine exposing the same surface
    the front door drives (queue/live/retired/submit/step). Token i+1
    follows token i; requests retire on budget."""

    class Toy:
        def __init__(self):
            self.queue = deque()
            self.live = [None] * slots
            self.retired = []

        def submit(self, req):
            self.queue.append(req)

        def step(self):
            for s in range(slots):
                if self.live[s] is None and self.queue:
                    req = self.queue.popleft()
                    req.tokens.append(int(req.prompt[-1]) + 1)
                    if len(req.tokens) >= req.max_new_tokens:
                        req.done = True
                        self.retired.append(req)
                    else:
                        self.live[s] = req
            for s, req in enumerate(self.live):
                if req is None:
                    continue
                req.tokens.append(req.tokens[-1] + 1)
                if len(req.tokens) >= req.max_new_tokens:
                    req.done = True
                    self.retired.append(req)
                    self.live[s] = None
            return sum(r is not None for r in self.live)

    return Toy()


def test_serve_front_door_completes_requests(worker):
    job = IJob("serve-test")
    fd = ServeFrontDoor(_toy_engine(), worker, job=job)
    tix = [fd.submit(np.asarray([i], np.int32), max_new_tokens=3, tenant=f"t{i % 2}")
           for i in range(5)]
    done = fd.run_until_drained()
    assert len(done) == 5
    for i, t in enumerate(tix):
        req = t.result(5.0)
        assert req.tokens == [i + 1, i + 2, i + 3]
        assert t.latency_ms > 0
    st = fd.stats()
    assert st["completed"] == 5 and st["waiting"] == 0 and st["live"] == 0
    # tick tasks are first-class job tasks (kind "serve") in the job DAG
    assert job.metrics("tasks")["serve"] >= 1
    assert "serve.tick#0" in job.explain()


def test_serve_front_door_sheds_beyond_queue_depth(worker):
    worker.cluster.props["ignis.serve.queue.depth"] = "2"
    fd = ServeFrontDoor(_toy_engine(), worker)
    tix = [fd.submit(np.asarray([0], np.int32), max_new_tokens=2) for _ in range(5)]
    shed = [t for t in tix if t.shed]
    assert len(shed) == 3
    for t in shed:  # a shed ticket resolves immediately to None
        assert t.done() and t.result() is None
    fd.run_until_drained()
    assert all(t.done() for t in tix)
    snap = fd.telemetry.snapshot()
    assert snap["shed"] == 3 and snap["completed"] == 2


def test_serve_single_tick_request_resolves(worker):
    fd = ServeFrontDoor(_toy_engine(), worker)
    t = fd.submit(np.asarray([7], np.int32), max_new_tokens=1)
    fd.tick_async().result(5.0)
    assert t.done() and t.result().tokens == [8]


def test_front_door_drives_the_real_engine_on_a_port_worker(worker):
    """Decode ticks of a real engine run as IJob tasks of kind ``serve``;
    every request resolves with its greedy tokens."""
    cfg, bundle, params = _tiny()
    tel = StreamTelemetry()
    job = tel.attach(IJob("serve"))
    fd = ServeFrontDoor(ServeEngine(bundle, params, slots=2, cache_len=32), worker,
                        job=job, telemetry=tel)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, 5, dtype=np.int32) for _ in range(3)]
    tix = [fd.submit(p, max_new_tokens=4) for p in prompts]
    fd.run_until_drained()
    for p, t in zip(prompts, tix):
        assert t.result(5.0).tokens == _greedy_reference(bundle, params, p, 4)
    tasks = job.metrics("tasks")
    assert tasks["serve"] == fd.stats()["ticks"] > 0 and tasks["failed"] == 0
    assert job.metrics("stream")["completed"] == 3


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_serve_cli_runs_on_the_cpu(capsys):
    done = serve_cli.main(["--arch", "ignis-tiny", "--device", "cpu", "--requests", "3",
                           "--max-new", "4"])
    assert len(done) == 3 and all(len(r.tokens) == 4 for r in done)
    assert "[serve] 3 requests, 12 tokens" in capsys.readouterr().out
    # the engine feeds token prompts; the audio bundle's prefill needs frames
    with pytest.raises(KeyError, match="frames"):
        serve_cli.main(["--arch", "whisper-tiny", "--reduced", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["mamba2-780m", "mixtral-8x7b", "jamba-1.5-large-398b",
                                  "internvl2-1b"])
def test_serve_cli_runs_the_ssm_and_moe_families_on_the_cpu(arch, capsys):
    done = serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "3",
                           "--max-new", "4"])
    assert len(done) == 3 and all(len(r.tokens) == 4 for r in done)
    assert "[serve] 3 requests, 12 tokens" in capsys.readouterr().out
