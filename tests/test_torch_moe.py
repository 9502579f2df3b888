"""The port's MoE family (the router, ``moe_ffn``, the MoE transformer)
against the JAX package's, on the same inputs (numpy, from a seed) and the
same weights (carried by ``interop.params_from_reference``).

On the CPU the port's ``moe_route`` takes its plain version; the JAX
``moe_route`` runs its Pallas kernel in interpret mode, as
tests/test_kernels.py runs it. The CUDA kernel itself is held against the
plain version on the card by ``tests/test_torch_card_kernels.py`` and
``chip_smoke.py``.

Tolerances. The router's expert ids, ordinals and keep flags are integers
and must be equal; its weights are f32 ratios of exponentials, held to
1e-6 (the two libraries' exp may differ in the last bit). ``moe_ffn`` and
the model in f32 are held to 1e-4 of the output's scale (summation order).
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.kernels.moe_route import moe_route as j_moe_route  # noqa: E402
from repro.kernels.moe_route import moe_route_ref as j_moe_route_ref  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.interop import params_from_reference  # noqa: E402
from repro_torch.kernels.moe_route import moe_route, moe_route_ref  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402

route_mod = importlib.import_module("repro_torch.kernels.moe_route.moe_route")

W_ATOL = 1e-6
TOL = 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x)


def _close(got, want, tol=TOL):
    want = np.asarray(_np(want), np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(_np(got), want, atol=tol * scale, rtol=tol)


def _route_equal(got, want):
    (wt, it, pt, kt), (wj, ij, pj, kj) = got, want
    assert it.dtype == torch.int32 and pt.dtype == torch.int32 and kt.dtype == torch.bool
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    assert wt.dtype == torch.float32
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=W_ATOL, rtol=0)


def _logits(seed, T, E, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, E)).astype(np.float32)
    if ties:  # whole rows equal, the top two equal, and equal runners-up
        x[::3] = 0.5
        x[1::3, :2] = 2.0
        x[2::3, 1:] = x[2::3, 1:2]
    return x


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,E,k,C,bt,ties", [
    (512, 8, 2, 64, 128, False),  # tests/test_kernels.py's three
    (300, 16, 2, 30, 256, False),
    (128, 4, 1, 40, 128, False),
    (4, 8, 2, 2, 256, False),  # a decode tick: 4 slots, capacity 2
    (300, 8, 2, 64, 128, True),
    (97, 4, 1, 10, 32, True),
])
def test_moe_route_matches_the_jax_kernel_and_oracle(T, E, k, C, bt, ties):
    x = _logits(T * E + k, T, E, ties)
    got = moe_route(torch.from_numpy(x), k, C, bt)
    _route_equal(got, j_moe_route(jnp.asarray(x), k, C, bt, True))
    _route_equal(got, j_moe_route_ref(jnp.asarray(x), k, C))
    assert (got[2] >= C).any() == (not got[3].all())  # some drops iff some pos >= C


def test_moe_route_ordinals_match_the_argsort_path():
    """The ordinals agree with models/moe.moe_ffn's argsort path (the check
    of tests/test_kernels.py, on the port's router)."""
    cfg = t_config("mixtral-8x7b").reduced()
    T, E, k = 64, cfg.num_experts, cfg.experts_per_token
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((T, cfg.d_model)).astype(np.float32) @ \
        rng.standard_normal((cfg.d_model, E)).astype(np.float32)
    _, idx, pos, _ = moe_route(torch.from_numpy(logits), k, 16, 64)
    e_flat = idx.numpy().reshape(-1)
    order = np.argsort(e_flat, kind="stable")
    counts = np.bincount(e_flat, minlength=E)
    starts = np.cumsum(counts) - counts
    pos_ref = np.empty_like(e_flat)
    pos_ref[order] = np.arange(len(e_flat)) - starts[e_flat[order]]
    np.testing.assert_array_equal(pos.numpy().reshape(-1), pos_ref)


def test_moe_route_padding_claims_no_ordinal_before_real_tokens():
    x = torch.from_numpy(_logits(2, 300, 8))
    padded = moe_route(x, 2, 40, block_t=128)  # pads 300 to 384
    whole = moe_route_ref(x, 2, 40)
    for a, b in zip(padded, whole):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_moe_route_routes_non_finite_rows_as_the_oracle_does():
    """A row with a NaN, an all -inf row and a row with +inf have only NaN
    probabilities; the plain version (which the CUDA kernel must equal)
    ranks NaN highest, the first one winning, as ``jax.lax.top_k`` in the
    JAX oracle does: experts 0 and 1, with NaN weights, and ordinals in
    range. (The Pallas kernel picks expert 0 twice there.)"""
    x = _logits(4, 9, 8)
    x[1, 3], x[4], x[7, 7] = np.nan, -np.inf, np.inf
    got = moe_route(torch.from_numpy(x), 2, 4)
    want = j_moe_route_ref(jnp.asarray(x), 2, 4)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    bad = [1, 4, 7]
    assert got[1][bad].tolist() == [[0, 1]] * 3
    w = got[0].numpy()
    assert np.isnan(w[bad]).all() and not np.isnan(np.delete(w, bad, 0)).any()
    np.testing.assert_allclose(np.delete(w, bad, 0),
                               np.delete(np.asarray(want[0]), bad, 0), atol=W_ATOL, rtol=0)


def test_moe_route_cpu_calls_take_the_plain_version_and_count_no_launch():
    kernels.reset_launches()
    moe_route(torch.from_numpy(_logits(1, 10, 4)), 2, 3)
    fn = kernels.launch_counters()["moe_route"]
    assert fn is route_mod.moe_route_fwd
    assert fn.launches == 0 and fn.tune_launches == 0 and not fn.geometries


# ---------------------------------------------------------------------------
# moe_ffn and the model
# ---------------------------------------------------------------------------


def _pair(dtype="float32", **over):
    over = dict(param_dtype=dtype, **over)
    return (j_config("mixtral-8x7b").reduced().with_overrides(**over),
            t_config("mixtral-8x7b").reduced().with_overrides(**over))


def _models(dtype="float32", seed=0, **over):
    jc, tc = _pair(dtype, **over)
    jb, tb = j_build(jc), t_build(tc)
    jp = jb.init(jax.random.PRNGKey(seed))
    return jb, jp, tb, params_from_reference(jax.tree.map(np.asarray, jp), tc), tc


@pytest.mark.parametrize("T,capacity", [(40, None), (40, 3), (4, None)])
def test_moe_ffn_matches_the_reference(T, capacity):
    """``capacity=3`` drops assignments (40 tokens x 2 over 4 experts)."""
    jb, jp, tb, tp, cfg = _models()
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["ffn"])
    tl = tp.layers[0].ffn
    x = np.random.default_rng(T).standard_normal((T, cfg.d_model)).astype(np.float32)
    yj, auxj = j_moe.moe_ffn(jnp.asarray(x), jl, cfg, capacity)
    with torch.no_grad():
        yt, auxt = t_moe.moe_ffn(torch.from_numpy(x), tl, cfg, capacity)
    assert yt.dtype == torch.float32 and auxt.dtype == torch.float32
    _close(yt, yj)
    _close(auxt, auxj)
    if capacity is not None:
        _, _, _, keep = moe_route(torch.from_numpy(x) @ tl.router.detach(), 2, capacity)
        assert not keep.all()
    assert t_moe.capacity_for(cfg, 4) == j_moe.capacity_for(cfg, 4) == 2


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_moe_prefill_and_decode_match_the_reference(impl):
    jb, jp, tb, tp, cfg = _models(attn_impl=impl)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 21)).astype(np.int32)
    jl, jc = jb.prefill(jp, tokens=jnp.asarray(toks), cache_len=32)
    tl, tc = tb.prefill(tp, tokens=torch.from_numpy(toks), cache_len=32)
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tc[key], jc[key])
    for _ in range(4):
        nt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jb.decode_step(jp, jc, jnp.asarray(nt))
        tl, tc = tb.decode_step(tp, tc, torch.from_numpy(nt))
        _close(tl, jl)
    assert tc["pos"].tolist() == [25, 25]


def test_moe_layers_route_through_the_router_in_prefill_and_decode(monkeypatch):
    """Every layer's FFN calls the router wrapper: the prefill with all of
    its tokens, a decode tick with one per slot."""
    import repro_torch.kernels.moe_route as pkg

    calls = []
    real = pkg.moe_route
    monkeypatch.setattr(pkg, "moe_route",
                        lambda logits, k, c, *a: calls.append((logits.shape[0], c))
                        or real(logits, k, c, *a))
    _, _, tb, tp, cfg = _models()
    toks = torch.zeros((1, 21), dtype=torch.int32)
    _, cache = tb.prefill(tp, tokens=toks, cache_len=32)
    slab = tb.make_cache(4, 32, device="cpu")
    tb.decode_step(tp, slab, torch.zeros((4, 1), dtype=torch.int32))
    cap = t_moe.capacity_for(cfg, 21)
    assert calls == [(21, cap)] * cfg.num_layers + [(4, 2)] * cfg.num_layers


def test_carried_moe_weights_are_bit_for_bit():
    jc, tc = _pair("bfloat16")
    pnp = jax.tree.map(np.asarray, j_build(jc).init(jax.random.PRNGKey(5)))
    tp = params_from_reference(pnp, tc)
    ffn = pnp["layers"]["ffn"]
    assert ffn["router"].dtype == np.float32 and ffn["w_gate"].dtype.name == "bfloat16"
    for i in range(tc.num_layers):
        got = tp.layers[i].ffn
        np.testing.assert_array_equal(got.router.detach().numpy(), ffn["router"][i])
        for name in ("w_gate", "w_up", "w_down"):
            t = getattr(got, name).detach()
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          ffn[name][i].view(np.int16))
    bad = jax.tree.map(lambda a: a, pnp)
    del bad["layers"]["ffn"]["w_up"]
    with pytest.raises(KeyError):
        params_from_reference(bad, tc)


def test_port_moe_init_draws_experts_with_their_fan_in():
    cfg = t_config("mixtral-8x7b").reduced()
    a = t_build(cfg).init(torch.Generator().manual_seed(0))
    ffn = a.layers[0].ffn
    assert ffn.router.dtype == torch.float32 and ffn.w_gate.dtype == torch.bfloat16
    assert tuple(ffn.w_gate.shape) == (cfg.num_experts, cfg.d_model, cfg.d_ff)
    assert tuple(ffn.w_down.shape) == (cfg.num_experts, cfg.d_ff, cfg.d_model)
    assert ffn.w_down.float().abs().max() <= 2.0 / cfg.d_ff**0.5 + 1e-2
    assert ffn.w_gate.float().abs().max() <= 2.0 / cfg.d_model**0.5 + 1e-2
    assert dataclasses.asdict(cfg)["sliding_window"] == 16
