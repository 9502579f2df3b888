"""The port's optimizer, schedule and gradient compression against the JAX
package's, on the same numpy inputs (from a seed).

Tolerances. ``warmup_cosine`` of a tensor or a Python step is computed in
f32 by the same operations: rel 1e-6 (the two libraries' cos may differ in
the last bit). ``adamw_update``: rel 1e-6 on the parameters and
moments (f32 arithmetic in the same order; XLA may contract a multiply-add),
the step counter exactly; bf16 moments and parameters may land one bf16 ulp
apart where the f32 value sits on a rounding tie, so they are held to one
ulp (2^-8 relative). ``compressed_grads``: int8 and none exactly (IEEE
division, rounding half to even, the same clip), top-k exactly (the same
threshold and ties kept by ``>=``), and the error-feedback state exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.distributed import compression as jcomp  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro_torch.distributed import compression as tcomp  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedule as tsched  # noqa: E402

REL = 1e-6
BF16_ULP = 2.0**-8


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((7, 5)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32),
            "s": (rng.standard_normal((3, 4)) * 1e-3).astype(np.float32)}


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (20, 16)])
def test_warmup_cosine_matches_jax(warmup, total):
    for s in range(0, total + 5):
        want = float(jsched.warmup_cosine(jnp.int32(s), 3e-4, warmup, total))
        got = tsched.warmup_cosine(torch.tensor(s, dtype=torch.int32), 3e-4, warmup, total)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), want, rtol=REL, atol=0)
        py = tsched.warmup_cosine(s, 3e-4, warmup, total)
        assert py.dtype == torch.float32 and py.shape == ()
        np.testing.assert_allclose(float(py), float(jsched.warmup_cosine(s, 3e-4, warmup, total)),
                                   rtol=REL, atol=0)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("params", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(moments, params):
    p0 = _tree(0)
    jp = {k: jnp.asarray(v).astype(params) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(getattr(torch, params)) for k, v in p0.items()}
    jopt = jadamw.init_opt_state(jp, jnp.dtype(moments))
    topt = tadamw.init_opt_state(tp, getattr(torch, moments))
    assert topt["step"].dtype == torch.int32 and topt["step"].shape == ()
    assert all(m.dtype == getattr(torch, moments) for m in topt["m"].values())
    for i in range(5):
        g = _tree(10 + i)
        jg = {k: jnp.asarray(v).astype(params) for k, v in g.items()}
        tg = {k: torch.from_numpy(v).to(getattr(torch, params)) for k, v in g.items()}
        lr = float(jsched.warmup_cosine(i, 1e-2, 2, 5))
        jp, jopt = jadamw.adamw_update(jg, jopt, jp, lr=lr)
        tp_out, topt = tadamw.adamw_update(tg, topt, tp, lr=lr)
        assert tp_out is tp  # updated in place
        assert int(topt["step"]) == int(jopt["step"]) == i + 1
        for k in p0:
            for got, want, dt in ((tp[k], jp[k], params), (topt["m"][k], jopt["m"][k], moments),
                                  (topt["v"][k], jopt["v"][k], moments)):
                assert str(got.dtype).split(".")[-1] == dt
                tol = REL if dt == "float32" else BF16_ULP
                np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=0)


def test_adamw_takes_a_tensor_lr_and_keeps_the_reference_tree():
    """A 0-d lr tensor (the schedule's, on the device) gives the update a
    Python lr gives; the state is exactly ``{m, v, step}``."""
    p0 = _tree(3)
    a = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    b = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    oa, ob = tadamw.init_opt_state(a), tadamw.init_opt_state(b)
    g = {k: torch.from_numpy(v) for k, v in _tree(4).items()}
    lr = tsched.warmup_cosine(torch.tensor(3, dtype=torch.int32), 1e-2, 5, 10)
    _, oa = tadamw.adamw_update(g, oa, a, lr=lr)
    _, ob = tadamw.adamw_update(g, ob, b, lr=float(lr))
    assert set(oa) == {"m", "v", "step"}
    for k in p0:
        assert torch.equal(a[k], b[k])


def _compress_pair(method, steps=4, frac=0.05):
    g0 = _tree(5)
    g0["big"] = np.random.default_rng(6).standard_normal(400).astype(np.float32)
    g0["big"][::37] = 0.25  # ties at a magnitude some top-k cuts through
    jef = jcomp.init_ef_state({k: jnp.asarray(v) for k, v in g0.items()})
    tef = tcomp.init_ef_state({k: torch.from_numpy(v) for k, v in g0.items()})
    for i in range(steps):
        g = {k: v * (1 + 0.5 * i) for k, v in g0.items()}
        jgc, jef = jcomp.compressed_grads({k: jnp.asarray(v) for k, v in g.items()}, jef,
                                          method, topk_frac=frac)
        tgc, tef = tcomp.compressed_grads({k: torch.from_numpy(v) for k, v in g.items()}, tef,
                                          method, topk_frac=frac)
        for k in g:
            assert tgc[k].dtype == torch.float32 and tef[k].dtype == torch.float32
            np.testing.assert_array_equal(tgc[k].numpy(), np.asarray(jgc[k]))
            np.testing.assert_array_equal(tef[k].numpy(), np.asarray(jef[k]))


@pytest.mark.parametrize("method,frac", [("int8", 0.05), ("topk", 0.05), ("topk", 0.2),
                                         ("none", 0.05)])
def test_compressed_grads_match_jax_with_equal_error_feedback(method, frac):
    _compress_pair(method, frac=frac)


def test_compressed_grads_keep_the_gradient_dtype_and_reject_unknown_methods():
    g = {"w": torch.randn(64, generator=torch.Generator().manual_seed(0)).bfloat16()}
    gc, ef = tcomp.compressed_grads(g, tcomp.init_ef_state(g), "int8")
    assert gc["w"].dtype == torch.bfloat16 and ef["w"].dtype == torch.float32
    with pytest.raises(ValueError):
        tcomp.compressed_grads(g, ef, "fp4")


def test_int8_error_feedback_preserves_the_sum():
    """tests/test_optim_and_compression.py's EF property on the port."""
    g = {"w": torch.linspace(-1, 1, 64)}
    ef = tcomp.init_ef_state(g)
    total = torch.zeros(64)
    for _ in range(50):
        gc, ef = tcomp.compressed_grads(g, ef, "int8")
        total += gc["w"]
    assert float((total - g["w"] * 50).abs().max()) < 0.02


def test_compressed_training_converges():
    w = {"w": torch.tensor([5.0, -3.0])}
    ef, opt = tcomp.init_ef_state(w), tadamw.init_opt_state(w)
    for _ in range(200):
        gc, ef = tcomp.compressed_grads({"w": 2 * w["w"]}, ef, "int8")
        w, opt = tadamw.adamw_update(gc, opt, w, lr=5e-2, weight_decay=0.0)
    assert float(w["w"].abs().max()) < 0.1
