"""The port's SSM family (the SSD scan, the Mamba-2 mixer, the SSM LM)
against the JAX package's, on the same inputs (numpy, from a seed) and the
same weights (carried by ``interop.params_from_reference``).

On the CPU the port's ``ssd_scan`` takes its plain version, ``ssd_chunked``;
the JAX ``ssd_scan`` runs its Pallas kernel in interpret mode, as
tests/test_kernels.py runs it. The CUDA kernel itself is held against the
plain version on the card by ``tests/test_torch_card_kernels.py`` and
``chip_smoke.py``.

Tolerances. The SSD in f32 is held to atol 2e-4, rtol 1e-3, the JAX kernel
test's own: the two packages take the cumulative decays and the chunk
products in other orders, and an exp of a cumulative sum carries that
difference into every later step of the chunk. The mixer and the model in
f32 are held to 1e-4 of the output's scale (summation order only). In bf16
the SSD alone is held to 3e-2 of its output's scale (one chunk: a value
near a rounding tie lands one ulp, 2^-8, apart). The bf16 model is held to
a relative L2 error of 0.1: torch rounds every elementwise step to bf16
(the 4-tap conv's sums, the gate) where XLA keeps f32 inside a fusion, which
gives the mixers' outputs about 0.8 % relative L2 each on identical inputs
(measured on the reduced model), compounded over 4 layers and 4 decode
steps (0.03 to 0.058 measured).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.kernels.ssd_scan import ssd_ref as j_ssd_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import mamba2 as j_mamba2  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.interop import params_from_reference  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_ref, ssd_scan  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import mamba2 as t_mamba2  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402

ssd_mod = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")

SSD_ATOL, SSD_RTOL = 2e-4, 1e-3
TOL = 1e-4
BF16_TOL = 3e-2
BF16_REL_L2 = 0.1


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=TOL):
    want = _np(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(_np(got), want, atol=tol * scale, rtol=tol)


def _close_l2(got, want, tol):
    got, want = _np(got), _np(want)
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert rel <= tol, f"relative L2 {rel} beyond {tol}"


def _ssd_inputs(seed, B, S, H, P, G, N):
    """x ~ N(0, 1), dt = softplus(N(0, 1)), A_log ~ N(0, 0.5), B/C ~ N(0, 0.3):
    the JAX kernel test's distributions."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A_log = (rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    return x, dt, A_log, Bm, Cm


SHAPES = [  # (B, S, H, P, G, N, chunk): tests/test_kernels.py's three, then a ragged S
    (2, 128, 4, 16, 1, 32, 32),
    (1, 256, 8, 64, 1, 128, 64),
    (2, 64, 4, 16, 2, 16, 16),
    (2, 75, 4, 16, 2, 16, 16),
]


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,H,P,G,N,q", SHAPES)
def test_ssd_chunked_matches_the_jax_oracle(B, S, H, P, G, N, q):
    a = _ssd_inputs(B * S + H + N, B, S, H, P, G, N)
    yj, sj = j_mamba2.ssd_chunked(*map(jnp.asarray, a), q)
    yt, st = t_mamba2.ssd_chunked(*map(torch.from_numpy, a), q)
    assert yt.dtype == torch.float32 and tuple(yt.shape) == (B, S, H, P)
    assert st.dtype == torch.float32 and tuple(st.shape) == (B, H, P, N)
    np.testing.assert_allclose(_np(yt), _np(yj), atol=SSD_ATOL, rtol=SSD_RTOL)
    np.testing.assert_allclose(_np(st), _np(sj), atol=SSD_ATOL, rtol=SSD_RTOL)


@pytest.mark.parametrize("B,S,H,P,G,N,q", SHAPES)
def test_ssd_scan_on_the_cpu_matches_the_jax_kernel(B, S, H, P, G, N, q):
    """The JAX kernel takes S % chunk == 0 only: a ragged S is held against
    its oracle, which pads as the port's wrapper pads."""
    a = _ssd_inputs(7 * S + P, B, S, H, P, G, N)
    ja = list(map(jnp.asarray, a))
    yj, sj = (j_ssd_scan(*ja, q, True) if S % q == 0 else j_ssd_ref(*ja, q))
    yt, st = ssd_scan(*map(torch.from_numpy, a), q)
    assert tuple(yt.shape) == (B, S, H, P)
    np.testing.assert_allclose(_np(yt), _np(yj), atol=SSD_ATOL, rtol=SSD_RTOL)
    np.testing.assert_allclose(_np(st), _np(sj), atol=SSD_ATOL, rtol=SSD_RTOL)


def test_ssd_chunked_in_bf16_rounds_where_the_reference_rounds():
    a = _ssd_inputs(3, 1, 64, 4, 16, 1, 16)
    x, Bm, Cm = (t.astype(jnp.bfloat16) for t in (jnp.asarray(a[0]), jnp.asarray(a[3]),
                                                   jnp.asarray(a[4])))
    yj, sj = j_mamba2.ssd_chunked(x, jnp.asarray(a[1]), jnp.asarray(a[2]), Bm, Cm, 16)
    tb = [torch.from_numpy(t).to(torch.bfloat16) for t in (a[0], a[3], a[4])]
    yt, st = t_mamba2.ssd_chunked(tb[0], torch.from_numpy(a[1]), torch.from_numpy(a[2]),
                                  tb[1], tb[2], 16)
    assert yt.dtype == torch.bfloat16 and st.dtype == torch.float32
    _close(yt, yj, BF16_TOL)
    _close(st, sj, BF16_TOL)


def test_ssd_decode_matches_the_reference():
    rng = np.random.default_rng(4)
    b, h, p, g, n = 3, 4, 16, 2, 8
    state = rng.standard_normal((b, h, p, n)).astype(np.float32)
    x = rng.standard_normal((b, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, h)))).astype(np.float32)
    A_log = (rng.standard_normal(h) * 0.5).astype(np.float32)
    Bm = rng.standard_normal((b, g, n)).astype(np.float32)
    Cm = rng.standard_normal((b, g, n)).astype(np.float32)
    args = (state, x, dt, A_log, Bm, Cm)
    yj, sj = j_mamba2.ssd_decode(*map(jnp.asarray, args))
    yt, st = t_mamba2.ssd_decode(*map(torch.from_numpy, args))
    _close(yt, yj)
    _close(st, sj)


def test_ssd_scan_cpu_calls_take_the_plain_version_and_count_no_launch():
    kernels.reset_launches()
    a = [torch.from_numpy(t) for t in _ssd_inputs(5, 1, 40, 2, 16, 1, 8)]
    y, st = ssd_scan(*a, 16)
    yr, sr = ssd_ref(*a, 16)
    torch.testing.assert_close(y, yr, atol=0, rtol=0)
    torch.testing.assert_close(st, sr, atol=0, rtol=0)
    fn = kernels.launch_counters()["ssd_scan"]
    assert fn is ssd_mod.ssd_scan_fwd
    assert fn.launches == 0 and fn.tune_launches == 0 and not fn.geometries
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_mod._check(*a, 40)


@pytest.mark.parametrize("name", ["ssd_scan", "moe_route"])
def test_new_cuda_sources_build_to_keyed_libraries(name, tmp_path, monkeypatch):
    """Each CUDA source builds under build/kernels/cuda to a library named
    by a hash of its sources and flags, and its note names the TPU kernel
    it replaces."""
    path = _cuda.library_path(name)
    assert path.parent == kernels.BUILD_DIR / "cuda" and path.name.startswith(f"{name}-")
    src = (_cuda.CSRC / f"{name}.cu").read_text()
    assert f"Replaces the Pallas TPU kernel src/repro/kernels/{name}/{name}.py" in src
    assert f'extern "C" const char* {name}_error_string' in src
    (tmp_path / f"{name}.cu").write_text(src + "\n// edited\n")
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    assert _cuda.library_path(name) != path


# ---------------------------------------------------------------------------
# the mixer and the model
# ---------------------------------------------------------------------------


def _pair(dtype):
    over = dict(param_dtype=dtype)
    return (j_config("mamba2-780m").reduced().with_overrides(**over),
            t_config("mamba2-780m").reduced().with_overrides(**over))


def _models(dtype, seed=0):
    """The reduced mamba2-780m in both packages, on the JAX weights with the
    mixer's f32 vectors (zeros and ones at init) drawn at random, so that
    A, Δ's bias, the conv bias, the skip and the gated norm all matter."""
    jc, tc = _pair(dtype)
    jb, tb = j_build(jc), t_build(tc)
    pnp = jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    mixer = pnp["layers"]["mixer"]
    for name, scale in (("A_log", 0.5), ("dt_bias", 0.5), ("conv_b", 0.1),
                        ("Dskip", 0.5), ("norm", 0.1)):
        mixer[name] = (rng.standard_normal(mixer[name].shape) * scale).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, pnp)
    return jb, jp, tb, params_from_reference(pnp, tc), tc


def test_mamba_mixer_and_its_decode_match_the_reference():
    jb, jp, tb, tp, cfg = _models("float32", seed=1)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["mixer"])
    tl = tp.layers[0].mixer
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    yj, tail_j, st_j = j_mamba2.mamba_mixer(jnp.asarray(x), jl, cfg)
    with torch.no_grad():
        yt, tail_t, st_t = t_mamba2.mamba_mixer(torch.from_numpy(x), tl, cfg)
    _close(yt, yj)
    _close(tail_t, tail_j)
    _close(st_t, st_j)
    for step in range(3):
        xd = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        yj, tail_j, st_j = j_mamba2.mamba_mixer_decode(jnp.asarray(xd), jl, cfg, tail_j, st_j)
        with torch.no_grad():
            yt, tail_t, st_t = t_mamba2.mamba_mixer_decode(torch.from_numpy(xd), tl, cfg,
                                                           tail_t, st_t)
        _close(yt, yj)
        _close(tail_t, tail_j)
        _close(st_t, st_j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_prefill_and_decode_match_the_reference(dtype):
    jb, jp, tb, tp, cfg = _models(dtype)
    if dtype == "float32":
        close = _close
    else:
        def close(got, want):
            _close_l2(got, want, BF16_REL_L2)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 21)).astype(np.int32)
    jl, jc = jb.prefill(jp, tokens=jnp.asarray(toks))
    tl, tc = tb.prefill(tp, tokens=torch.from_numpy(toks))
    close(tl, jl)
    for key in ("conv", "state"):
        assert tuple(tc[key].shape) == tuple(jc[key].shape)
        assert str(tc[key].dtype).split(".")[1] == str(jc[key].dtype)
        close(tc[key], jc[key])
    assert tc["pos"].dtype == torch.int32 and tc["pos"].tolist() == [21, 21]
    for _ in range(4):
        nt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jb.decode_step(jp, jc, jnp.asarray(nt))
        tl, tc = tb.decode_step(tp, tc, torch.from_numpy(nt))
        close(tl, jl)
    assert tc["pos"].tolist() == [25, 25]
    close(tc["state"], jc["state"])


def test_ssm_cache_ignores_max_len_as_the_reference_does():
    jc, tc = _pair("float32")
    want = j_build(jc).make_cache(3, 999)
    got = t_build(tc).make_cache(3, 7, device="cpu")
    assert got.keys() == want.keys()
    for k in got:
        assert tuple(got[k].shape) == tuple(want[k].shape)
        assert str(got[k].dtype).split(".")[1] == str(want[k].dtype)
        assert not got[k].any()


def test_carried_ssm_weights_are_bit_for_bit():
    jc, tc = _pair("bfloat16")
    pnp = jax.tree.map(np.asarray, j_build(jc).init(jax.random.PRNGKey(5)))
    tp = params_from_reference(pnp, tc)
    assert isinstance(tp, t_ssm.SSMLM) and not hasattr(tp, "lm_head")  # tied head
    for name in ("in_proj", "conv_w", "out_proj"):
        want = pnp["layers"]["mixer"][name]
        assert want.dtype.name == "bfloat16"
        for i in range(tc.num_layers):
            got = getattr(tp.layers[i].mixer, name).detach()
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), want[i].view(np.int16))
    assert tp.layers[0].mixer.A_log.dtype == torch.float32
    np.testing.assert_array_equal(tp.embed.detach().view(torch.int16).numpy(),
                                  pnp["embed"].view(np.int16))
    bad = jax.tree.map(lambda a: a, pnp)
    bad["layers"]["mixer"]["extra"] = pnp["layers"]["mixer"]["A_log"]
    with pytest.raises(ValueError, match="extra"):
        params_from_reference(bad, tc)


def test_port_ssm_init_draws_on_the_generators_device():
    cfg = t_config("mamba2-780m").reduced()
    a = t_build(cfg).init(torch.Generator().manual_seed(0))
    b = t_build(cfg).init(torch.Generator().manual_seed(0))
    assert a.device == torch.device("cpu") and a.embed.dtype == torch.bfloat16
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    mixer = a.layers[0].mixer
    assert mixer.conv_w.abs().max() <= 2.0 / cfg.ssm_conv**0.5 + 1e-2  # fan-in = width
    assert torch.equal(mixer.Dskip, torch.ones(cfg.ssm_heads))


@pytest.mark.parametrize("dtype,lo,hi", [("float32", 0.0, 1e-4), ("bfloat16", 1e-2, 1.0)])
def test_full_depth_random_stack_amplifies_bf16_roundings_only(dtype, lo, hi, monkeypatch):
    """The measurement behind chip_smoke.py's Mamba checks: mamba2-780m at
    its full depth (48 layers) and reduced width, with random weights. A
    relative change of 1e-6 in every SSD output (computed in f32, rounded
    once to the model's dtype) moves the last logits by 1.1e-5 relative L2
    in f32, but by 6.5e-2 in bf16, where it flips roundings that the 48
    layers compound. So a comparison of logits holds an SSD kernel
    tightly in f32 only; in bf16 the kernel is held layer by layer."""
    cfg = t_config("mamba2-780m").reduced().with_overrides(num_layers=48, param_dtype=dtype)
    bundle = t_build(cfg)
    params = bundle.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 256)).astype(np.int32))
    g = torch.Generator().manual_seed(2)

    def f32_ssd(x, dt, A_log, Bm, Cm, chunk, eps=0.0):
        y, st = t_mamba2.ssd_chunked(x.float(), dt, A_log, Bm.float(), Cm.float(), chunk)
        y = y * (1 + eps * torch.randn(y.shape, generator=g))
        return y.to(x.dtype), st

    pkg = importlib.import_module("repro_torch.kernels.ssd_scan")
    monkeypatch.setattr(pkg, "ssd_scan", f32_ssd)
    base = bundle.prefill(params, tokens=toks)[0].float()
    monkeypatch.setattr(pkg, "ssd_scan", lambda *a: f32_ssd(*a, eps=1e-6))
    moved = bundle.prefill(params, tokens=toks)[0].float()
    rel = float((moved - base).norm() / base.norm())
    assert lo < rel < hi, rel
