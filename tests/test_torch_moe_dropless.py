"""The dropless MoE (``models/moe.moe_ffn_dropless``, Granite-4.0-H's) and
the router at its k = 10 of E = 72: the grouped expert path against a loop
over each token's routed experts, the router's plain version against
``torch.topk`` and a softmax over the chosen logits, the ``moe.experts``
span and its settled counts, the hybrid layouts (Granite's and Jamba's) on
the serve engine. The test marked ``cuda`` holds the grouped products on
the card against the loop and skips here (on the card: ``pytest -m cuda
tests/test_torch_moe_dropless.py``); the router kernel's card cases, k = 10
of 72 among them, are ``tests/test_torch_card_kernels.py``'s."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels.moe_experts import grouped_experts
from repro_torch.kernels.moe_route.ref import moe_route_ref
from repro_torch.models import build_model, hybrid
from repro_torch.models.moe import MoE, moe_ffn
from repro_torch.profile import spans
from repro_torch.serving import ServeEngine
from repro_torch.serving.engine import Request


def _granite(**kw):
    base = dict(num_experts=8, experts_per_token=3, param_dtype="float32")
    return get_config("granite-4.0-h-small").reduced().with_overrides(**{**base, **kw})


def _moe(cfg, seed=0, device="cpu", dtype=torch.float32):
    g = torch.Generator(device=device).manual_seed(seed)
    p = MoE(cfg, dtype, device, g)
    with torch.no_grad():  # a router that spreads the tokens unevenly
        p.router.mul_(4.0)
    return p


def loop_moe(x, p, k):
    """Each token through its top-k experts, one at a time: the softmax
    over the chosen logits weighs them; the shared expert added."""
    logits = x.float() @ p.router
    top, ids = logits.topk(k, dim=-1)
    gates = torch.softmax(top, dim=-1)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for t in range(x.shape[0]):
        for j in range(k):
            e = int(ids[t, j])
            h = F.silu(x[t] @ p.w_gate[e]) * (x[t] @ p.w_up[e])
            out[t] += gates[t, j] * (h @ p.w_down[e]).float()
    sh = p.shared
    return out + (F.silu(x @ sh.w_gate) * (x @ sh.w_up) @ sh.w_down).float()


@pytest.mark.parametrize("T", [1, 5, 300])
def test_dropless_moe_equals_the_loop_over_routed_experts(T):
    cfg = _granite()
    p = _moe(cfg)
    x = torch.randn((T, cfg.d_model), generator=torch.Generator().manual_seed(T))
    with torch.no_grad():
        y, aux = moe_ffn(x, p, cfg)
    torch.testing.assert_close(y, loop_moe(x, p, cfg.experts_per_token), atol=1e-5,
                               rtol=1e-5)
    assert torch.isfinite(aux)


def test_no_assignment_is_dropped_where_the_capacity_path_would_drop():
    """Every token on one expert: the capacity path drops past 1.25 x its
    share, the dropless path computes all of them."""
    cfg = _granite()
    p = _moe(cfg)
    with torch.no_grad():
        p.router.zero_()
        p.router[:, 2] = 10.0
    x = torch.rand((64, cfg.d_model), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y, _ = moe_ffn(x, p, cfg)
        y_cap, _ = moe_ffn(x, p, cfg.with_overrides(moe_dropless=False))
    want = loop_moe(x, p, cfg.experts_per_token)
    torch.testing.assert_close(y, want, atol=1e-5, rtol=1e-5)
    assert (y_cap - want).abs().max() > 1e-2


@pytest.mark.parametrize("ask", [dict(moe_dropless=True), dict(moe_shared_ff=96)],
                         ids=["dropless", "shared"])
def test_expert_parallelism_refuses_what_it_does_not_implement(ask):
    """EP has a capacity and no shared expert: a config with ``moe_ep`` that
    asks for either raises rather than drop tokens or skip the expert."""
    from repro_torch.models.moe_ep import ep_applicable

    base = dict(moe_dropless=False, moe_shared_ff=0)
    with pytest.raises(NotImplementedError):
        ep_applicable(_granite(moe_ep=True, **{**base, **ask}), 8)
    assert not ep_applicable(_granite(**ask), 8)


def test_grouped_products_skip_experts_with_no_rows():
    cfg = _granite()
    p = _moe(cfg)
    counts = torch.tensor([3, 0, 0, 5, 0, 1, 0, 0], dtype=torch.int32)
    xs = torch.randn((9, cfg.d_model), generator=torch.Generator().manual_seed(2))
    ys = grouped_experts(xs, p.w_gate, p.w_up, p.w_down,
                         torch.cumsum(counts, 0, dtype=torch.int32))
    experts = torch.repeat_interleave(torch.arange(8), counts.long())
    for r, e in enumerate(experts.tolist()):
        h = F.silu(xs[r] @ p.w_gate[e]) * (xs[r] @ p.w_up[e])
        torch.testing.assert_close(ys[r], h @ p.w_down[e], atol=1e-5, rtol=1e-5)
    assert grouped_experts.launches == 0  # counted on the card only


def _tied_logits(g, T, E):
    """Rows whose logits take four values: many exact ties."""
    return torch.randint(0, 4, (T, E), generator=g).float()


@pytest.mark.parametrize("kind", ["random", "tied"])
def test_router_plain_version_at_k10_of_72_is_topk_and_a_softmax_of_the_chosen(kind):
    g = torch.Generator().manual_seed(4)
    T, E, k = 700, 72, 10
    x = torch.randn((T, E), generator=g) * 3 if kind == "random" else _tied_logits(g, T, E)
    w, idx, pos, keep = moe_route_ref(x, k, T * k)
    top, ids = x.topk(k, dim=-1, sorted=True)
    if kind == "random":
        assert torch.equal(idx.long(), ids)
    else:  # a tie goes to the lower index, which topk does not promise
        want = torch.sort(x, dim=-1, descending=True, stable=True).indices[:, :k]
        assert torch.equal(idx.long(), want)
    torch.testing.assert_close(w, torch.softmax(x.gather(1, idx.long()), -1), atol=1e-6,
                               rtol=1e-5)
    flat = idx.reshape(-1).long()
    for e in range(E):  # ordinals: 0, 1, ... in token-major order within each expert
        assert torch.equal(pos.reshape(-1)[flat == e], torch.arange(int((flat == e).sum()),
                                                                    dtype=torch.int32))
    assert bool(keep.all())


def test_moe_experts_span_settles_its_counts_after_the_readback():
    cfg = _granite()
    p = _moe(cfg)
    x = torch.randn((40, cfg.d_model), generator=torch.Generator().manual_seed(5))
    buf = spans.TraceBuffer()
    with spans.recording(buf), torch.no_grad():
        moe_ffn(x, p, cfg)
        (sp,) = [s for s in buf.spans() if s.name == "moe.experts"]
        assert isinstance(sp.args["experts_hit"], torch.Tensor)
        spans.settle()
    ids = (x @ p.router).topk(cfg.experts_per_token, -1).indices
    e = len(set(ids.reshape(-1).tolist()))  # the experts hit, counted by hand
    assert sp.args == {"tokens": 40, "assignments": 120, "experts_hit": e}
    with torch.no_grad():  # off: no span, nothing deferred
        moe_ffn(x, p, cfg)
    spans.settle()
    assert len(buf) == 1


def _serve(cfg, n=3, slots=2):
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(0))
    eng = ServeEngine(bundle, params, slots=slots, cache_len=64)
    for i in range(n):
        eng.submit(Request(i, np.arange(5 + 3 * i, dtype=np.int32) % cfg.vocab_size,
                           max_new_tokens=4))
    return eng, eng.run_to_completion()


def test_granite_layout_serves_through_the_engine_and_records_its_spans():
    cfg = _granite()
    assert [m for m, _ in hybrid.period(cfg)] == ["mamba"] * 5 + ["attn"] + ["mamba"] * 4
    assert hybrid.mamba_slots(cfg) == 9 and hybrid.moe_layers(cfg) == 10
    buf = spans.TraceBuffer()
    with spans.recording(buf):
        eng, done = _serve(cfg)
    assert sorted(len(r.tokens) for r in done) == [4, 4, 4]
    assert tuple(eng.cache["state"].shape[:3]) == (1, 9, 2)
    moe = [s for s in buf.spans() if s.name == "moe.experts"]
    steps = [s for s in buf.spans() if s.name in ("engine.prefill", "engine.decode")]
    assert len(moe) == 10 * len(steps)
    assert all(isinstance(s.args["experts_hit"], int) and 1 <= s.args["experts_hit"] <= 8
               for s in moe)
    launches = [s for s in buf.spans() if s.name == "launch"]
    assert all(any(p.t0 <= s.t0 and s.t1 <= p.t1 for p in launches) for s in moe)


def test_jamba_still_builds_and_serves():
    cfg = get_config("jamba-1.5-large-398b").reduced()
    assert hybrid.period(cfg) == [("attn", "mlp")] + [
        ("mamba", "moe" if i % 2 else "mlp") for i in range(1, 8)]
    eng, done = _serve(cfg)
    assert sorted(len(r.tokens) for r in done) == [4, 4, 4]
    assert tuple(eng.cache["conv"].shape[:3]) == (1, 7, 2)
    assert [n for n, _ in eng.params.blocks[0].named_children()] == ["attn"] + [
        f"s{i}" for i in range(1, 8)]
    assert hasattr(eng.params, "lm_head")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 128, 1500])
def test_grouped_expert_path_on_the_card_equals_the_loop(card, T):
    cfg = get_config("granite-4.0-h-small").with_overrides(num_experts=16)
    p = _moe(cfg, device="cuda", dtype=torch.bfloat16)
    x = torch.randn((T, cfg.d_model), generator=torch.Generator(device="cuda").manual_seed(T),
                    device="cuda").to(torch.bfloat16)
    before = grouped_experts.launches
    with torch.no_grad():
        y, _ = moe_ffn(x, p, cfg)
        want = loop_moe(x, p, cfg.experts_per_token)
    assert grouped_experts.launches == before + 1
    rel = float((y.float() - want).norm() / want.norm())
    assert rel <= 1e-2, rel
