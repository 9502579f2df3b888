"""The port's dense model zoo against the JAX package's, on the same
weights (carried by ``interop.params_from_reference``) and the same inputs
(numpy, from a seed).

Tolerances: f32 models at 1e-4 (summation order and the exp/cos/sin of two
libraries differ in the last bits; the KV slab of the engine is bf16 in both
packages, so that rounding is the same on both sides). The bf16 case is held
to 3e-2 of the logits' scale: each framework rounds every activation to
bf16, and a value near a rounding tie may land one ulp (2^-8) apart, which
then travels through the layers.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from _torch_families import jax_fields  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import list_configs as j_list_configs  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs import list_configs  # noqa: E402
from repro_torch.interop import _tensor, params_from_reference  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models.model_zoo import analytic_param_count, build_module  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402

TOL = 1e-4
BF16_TOL = 3e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _pair(name, **over):
    """(JAX config, port config) of one architecture with the same overrides."""
    jc, tc = j_config(name), t_config(name)
    if name == "qwen3-14b":
        jc, tc = jc.reduced(), tc.reduced()
    return jc.with_overrides(**over), tc.with_overrides(**over)


def _models(name, **over):
    jc, tc = _pair(name, **over)
    jb, tb = j_build(jc), t_build(tc)
    jp = jb.init(jax.random.PRNGKey(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tc)
    return jb, jp, tb, tp, tc


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["qwen3-14b", "ignis-tiny", "ignis-100m", "mamba2-780m",
                                  "mixtral-8x7b", "jamba-1.5-large-398b", "internvl2-1b",
                                  "whisper-tiny"])
def test_configs_copy_the_reference(name):
    j, t = dataclasses.asdict(j_config(name)), jax_fields(dataclasses.asdict(t_config(name)))
    j.pop("source"), t.pop("source")
    assert j == t
    assert dataclasses.asdict(j_config(name).reduced()).keys() == \
        jax_fields(dataclasses.asdict(t_config(name).reduced())).keys()


def test_qwen3_14b_cites_its_published_config():
    assert t_config("qwen3-14b").source == "[hf:Qwen/Qwen3-14B; hf]"
    assert j_list_configs() == [
        "gemma3-4b", "ignis-100m", "ignis-tiny", "internvl2-1b", "jamba-1.5-large-398b",
        "mamba2-780m", "mixtral-8x7b", "olmo-1b", "phi3.5-moe-42b-a6.6b", "qwen3-14b",
        "whisper-tiny", "yi-9b"]
    # the port's one config of its own: granite-4.0-h-small (the JAX package has none)
    assert list_configs() == sorted(j_list_configs() + ["granite-4.0-h-small"])
    assert t_config("mamba2-780m").source == j_config("mamba2-780m").source
    assert t_config("mixtral-8x7b").source == j_config("mixtral-8x7b").source


def test_unported_architectures_and_families_raise():
    """No architecture is left unported: every JAX config has a port config
    with the same fields and ``source`` (but qwen3-14b's citation, above),
    and each builds its family's module (on the ``meta`` device: no
    storage), the hybrid, VLM and audio families included; the MoE
    ``ignis-tiny`` builds too. An unknown family still raises."""
    for name in j_list_configs():
        j, t = dataclasses.asdict(j_config(name)), jax_fields(dataclasses.asdict(t_config(name)))
        if name == "qwen3-14b":
            j.pop("source"), t.pop("source")
        assert j == t, name
        module = build_module(t_config(name), device="meta")
        assert sum(p.numel() for p in module.parameters()) > 0, name
    with pytest.raises(ValueError, match="unknown family"):
        build_module(t_config("ignis-tiny").with_overrides(family="diffusion"), device="meta")
    moe = t_config("ignis-tiny").with_overrides(num_experts=4, experts_per_token=2)
    lm = t_build(moe).init(torch.Generator().manual_seed(0))
    assert tuple(lm.layers[0].ffn.w_gate.shape) == (4, moe.d_model, moe.d_ff)


@pytest.mark.parametrize("name", j_list_configs())
def test_analytic_param_counts_equal_jax(name):
    """``analytic_param_count`` (total and active) and the config's
    ``param_count``/``active_param_count`` equal the JAX package's exactly,
    at full size."""
    j, t = j_config(name), t_config(name)
    assert t.param_count() == analytic_param_count(t) == j.param_count()
    assert t.active_param_count() == analytic_param_count(t, active_only=True) \
        == j.active_param_count()


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_rope_and_mlp(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    bias = rng.standard_normal(16).astype(np.float32) * 0.1
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    out = t_layers.rmsnorm(tx, torch.from_numpy(scale))
    assert out.dtype == td
    _close(out, j_layers.rmsnorm(jx, jnp.asarray(scale)), tol)
    _close(t_layers.layernorm(tx, torch.from_numpy(scale), torch.from_numpy(bias)),
           j_layers.layernorm(jx, jnp.asarray(scale), jnp.asarray(bias)), tol)
    _close(t_layers.layernorm(tx), j_layers.layernorm(jx), tol)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    out = t_layers.rope(tx, torch.from_numpy(pos), 1e6)
    assert out.dtype == td
    # angles up to 5000 rad: the two libraries' cos/sin agree to ~1e-6 relative
    _close(out, j_layers.rope(jx, jnp.asarray(pos), 1e6), max(tol, 3e-4))
    w = {n: rng.standard_normal(s).astype(np.float32) * 0.2
         for n, s in (("w_gate", (16, 32)), ("w_up", (16, 32)), ("w_down", (32, 16)))}
    p = t_layers.MLP(16, 32, td)
    with torch.no_grad():
        for n, a in w.items():
            getattr(p, n).copy_(torch.from_numpy(a))
    _close(t_layers.mlp(tx, p).detach(),
           j_layers.mlp(jx, {n: jnp.asarray(a, jd) for n, a in w.items()}), tol)
    assert t_layers.softcap(tx, 0.0) is tx
    _close(t_layers.softcap(tx * 40, 30.0), j_layers.softcap(jx * 40, 30.0), tol * 30)


@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("window,causal,cap", [
    (t_attn.GLOBAL_WINDOW, True, 0.0), (5, True, 20.0), (t_attn.GLOBAL_WINDOW, False, 0.0)])
def test_attend_chunked_and_whole(chunk, window, causal, cap):
    rng = np.random.default_rng(1)
    B, Sq, H, K, hd = 2, 19, 6, 2, 16
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sq, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sq, K, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(Sq, dtype=np.int32), (B, Sq)).copy()
    pos_kv = pos.copy()
    pos_kv[1, -3:] = -1  # invalid slots
    want = j_attn.attend(*map(jnp.asarray, (q, k, v, pos, pos_kv)), window=window,
                         causal=causal, cap=cap, chunk=chunk)
    got = t_attn.attend(*map(torch.from_numpy, (q, k, v, pos, pos_kv)), window=window,
                        causal=causal, cap=cap, chunk=chunk)
    _close(got, want)


# ---------------------------------------------------------------------------
# the model: prefill and decode against the JAX package
# ---------------------------------------------------------------------------


def _prefill_then_decode(name, impl, dtype, tol, steps=4):
    jb, jp, tb, tp, cfg = _models(name, param_dtype=dtype, attn_impl=impl)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 21)).astype(np.int32)
    jl, jc = jb.prefill(jp, tokens=jnp.asarray(toks), cache_len=32)
    tl, tc = tb.prefill(tp, tokens=torch.from_numpy(toks), cache_len=32)
    scale = float(np.abs(_np(jl)).max())
    _close(tl, jl, tol * max(scale, 1.0))
    for key in ("k", "v"):
        assert tc[key].shape == jc[key].shape and _np(tc[key])[:, :, 21:].max() == 0
        _close(tc[key], jc[key], tol * max(float(np.abs(_np(jc[key])).max()), 1.0))
    assert tc["pos"].dtype == torch.int32 and tc["pos"].tolist() == [21, 21]
    for _ in range(steps):
        nt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jb.decode_step(jp, jc, jnp.asarray(nt))
        tl, tc = tb.decode_step(tp, tc, torch.from_numpy(nt))
        _close(tl, jl, tol * max(float(np.abs(_np(jl)).max()), 1.0))
    assert tc["pos"].tolist() == [21 + steps] * 2
    _close(tc["k"], jc["k"], tol * max(float(np.abs(_np(jc["k"])).max()), 1.0))


@pytest.mark.parametrize("impl", ["chunked", "flash"])
@pytest.mark.parametrize("name", ["qwen3-14b", "ignis-tiny"])
def test_prefill_and_decode_match_the_reference(name, impl):
    _prefill_then_decode(name, impl, "float32", TOL)


def test_prefill_and_decode_match_the_reference_in_bf16():
    _prefill_then_decode("qwen3-14b", "flash", "bfloat16", BF16_TOL)


def test_uneven_windows_keep_the_plain_path(monkeypatch):
    """The flash kernel serves a prefill only when every layer has the same
    window (the JAX package's rule: a per-layer window is traced there)."""
    import repro_torch.kernels.flash_attention as pkg

    calls = []
    real = pkg.flash_attention
    monkeypatch.setattr(pkg, "flash_attention",
                        lambda *a, **k: calls.append(a[4]) or real(*a, **k))
    toks = np.random.default_rng(4).integers(0, 256, (1, 24)).astype(np.int32)
    for over, want_calls in ((dict(sliding_window=8), [8] * 4),
                             (dict(local_global_period=1, local_window=8), [])):
        calls.clear()
        jb, jp, tb, tp, _ = _models("qwen3-14b", param_dtype="float32",
                                    attn_impl="flash", **over)
        tl, _ = tb.prefill(tp, tokens=torch.from_numpy(toks))
        jl, _ = jb.prefill(jp, tokens=jnp.asarray(toks))
        assert calls == want_calls
        _close(tl, jl, TOL)


def test_decode_writes_the_cache_in_place_and_clamps_like_the_reference():
    jb, jp, tb, tp, cfg = _models("ignis-tiny")
    cache = tb.make_cache(2, 8, device="cpu")
    cache["pos"] = torch.tensor([3, 8], dtype=torch.int32)  # slot 1 past the end
    k_before = cache["k"]
    jcache = {"k": jnp.zeros(cache["k"].shape, jnp.bfloat16),
              "v": jnp.zeros(cache["v"].shape, jnp.bfloat16),
              "pos": jnp.asarray([3, 8], jnp.int32)}
    toks = np.asarray([[5], [9]], np.int32)
    tl, tc = tb.decode_step(tp, cache, torch.from_numpy(toks))
    jl, jc = jb.decode_step(jp, jcache, jnp.asarray(toks))
    assert tc["k"] is k_before
    nz = [int(i) for i in torch.nonzero(tc["k"][0].float().abs().sum((-1, -2)))[:, 1]]
    assert sorted(set(nz)) == [3, 7]  # the write at 8 clamps to the last slot
    np.testing.assert_array_equal(_np(tc["k"]), _np(jc["k"]))
    _close(tl, jl)


def test_carried_bf16_weights_are_bit_for_bit():
    jc, tc = _pair("qwen3-14b", param_dtype="bfloat16")
    jp = j_build(jc).init(jax.random.PRNGKey(5))
    pnp = jax.tree.map(np.asarray, jp)
    assert pnp["embed"].dtype.name == "bfloat16"
    tp = params_from_reference(pnp, tc)
    assert tp.embed.dtype == torch.bfloat16 and tp.layers[0].ln1.scale.dtype == torch.float32
    np.testing.assert_array_equal(tp.embed.detach().view(torch.int16).numpy(),
                                  pnp["embed"].view(np.int16))
    for i in range(tc.num_layers):
        np.testing.assert_array_equal(
            tp.layers[i].attn.wq.detach().view(torch.int16).numpy(),
            pnp["layers"]["attn"]["wq"][i].view(np.int16))
    assert _tensor(np.asarray(jnp.asarray([1.5, -2.0], jnp.bfloat16))).tolist() == [1.5, -2.0]
    bad = jax.tree.map(lambda a: a, pnp)
    bad["layers"]["attn"]["extra"] = pnp["layers"]["attn"]["wq"]
    with pytest.raises(ValueError, match="extra"):
        params_from_reference(bad, tc)


def test_port_init_draws_on_the_generators_device_in_param_dtype():
    cfg = t_config("qwen3-14b").reduced()
    a = t_build(cfg).init(torch.Generator().manual_seed(0))
    b = t_build(cfg).init(torch.Generator().manual_seed(0))
    assert a.device == torch.device("cpu") and a.embed.dtype == torch.bfloat16
    assert a.layers[0].attn.q_norm.dtype == torch.float32
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    fan_in = cfg.d_model
    wq = a.layers[0].attn.wq.detach().float()
    assert wq.abs().max() <= 2.0 / fan_in**0.5 + 1e-2
    assert abs(float(wq.std()) * fan_in**0.5 - 0.88) < 0.1  # truncated at 2 sigma
    n = sum(p.numel() for p in a.parameters())
    assert n == t_tf.TransformerLM(cfg, device="meta").embed.numel() * 2 + sum(
        p.numel() for p in a.layers.parameters()) + cfg.d_model
