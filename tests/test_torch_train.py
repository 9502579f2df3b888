"""The port's training path against the JAX package's, on the same weights
(carried by ``interop.params_from_reference``) and the same batches (numpy,
from a seed): the chunked cross-entropy, ``train_loss`` and its gradients
leaf by leaf for the dense, MoE and SSM families with the chunked and the
flash attention, ``train_step`` with microbatches and with gradient
compression, the three kernels' ``autograd.Function`` backwards against the
JAX wrappers' custom vjps, checkpoints that resume across the packages, and
the training entry point's command line.

On the CPU each Function's forward is its kernel's plain version; the JAX
side runs its Pallas kernels in interpret mode, as its own tests do. The
weights are the port's initialisation from a seed, carried to the JAX
package by ``interop.params_to_reference`` and back into a port model by
``params_from_reference``. Each config's JAX loss and gradients are computed
once, with its chunked attention (the numerical oracle of its flash kernel),
and the port's chunked and flash paths are both held against them; the
JAX flash wrapper's own vjp is held against the port's Function below.

Tolerances. f32 (``param_dtype="float32"``): loss rel 1e-5, gradients rel
L2 1e-4 per leaf (summation order, and the two libraries' exp differ in
the last bits). bf16: the loss alone, rel 2e-2 (each framework rounds every
activation to bf16; a value near a tie lands an ulp apart and travels, and
the router sends a token to other experts on any such flip). Two optimizer
steps: parameters rel L2 1e-4 per leaf; moments elementwise within 1e-4
of the value and of the leaf's largest but for at most 1e-3 of a leaf's
elements (int8 compression quantises an element
one step apart where the two f32 gradients straddle a rounding boundary:
its moment then differs by a whole quantum). The Functions' backwards: 1e-5 of the scale.
Resumed runs: losses rel 1e-4.
"""
import functools
import json
import math
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as j_ssd  # noqa: E402
from repro.launch.train import train as j_train  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    opt_from_reference,
    opt_to_reference,
    params_from_reference,
    params_to_reference,
    reference_tree,
)
from repro_torch.kernels.flash_attention import flash_attention as t_flash  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as t_ssd  # noqa: E402
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_fwd  # noqa: E402
from repro_torch.launch import train as t_train_mod  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402

LOSS_REL = 1e-5
GRAD_REL_L2 = 1e-4
BF16_LOSS_REL = 2e-2
STEP_REL_L2 = 1e-4
FLIPPED = 1e-3
FN_TOL = 1e-5
RESUME_REL = 1e-4

#: reduced configs; gemma3 with a loss chunk (two chunks and a remainder of
#: S = 40), phi3.5-MoE with its 16 experts
CONFIGS = {
    "ignis-tiny": {},
    "olmo-1b": {},
    "qwen3-14b": {},
    "gemma3-4b": {"loss_chunk": 16},
    "mixtral-8x7b": {},
    "phi3.5-moe-42b-a6.6b": {"num_experts": 16},
    "mamba2-780m": {},
}
B, S = 2, 40


def _cfgs(name, **over):
    kw = {**CONFIGS[name], **over}
    return j_config(name).reduced().with_overrides(**kw), t_config(name).reduced().with_overrides(
        **kw)


def _batch(vocab, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (b, s)).astype(np.int32)
    lab = rng.integers(0, vocab, (b, s)).astype(np.int32)
    lab[:, :3] = -1  # masked positions
    lab[0, -5:] = -1
    return tok, lab


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel_l2(got, want) -> float:
    g, w = _f32(got).astype(np.float64), _f32(want).astype(np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*path, k))
    else:
        yield "/".join(path), tree


def _hold_trees(got, want, tol, what):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want), what
    bad = {k: _rel_l2(got[k], want[k]) for k in want}
    bad = {k: r for k, r in bad.items() if not r <= tol}
    assert not bad, f"{what}: leaves beyond rel L2 {tol}: {bad}"


@functools.lru_cache(maxsize=None)
def _params(name, dtype, seed=0):
    """Initial parameters of the reduced config in the JAX package's tree,
    as numpy: the port's f32 initialisation from ``seed`` (a few ms, where
    compiling the JAX ``init`` takes seconds), cast to the leaves' dtypes of
    the ``dtype`` config (as a bf16 config draws in f32 and casts), so one
    draw serves both dtypes."""
    jc, tc = _cfgs(name, param_dtype="float32")
    tree = params_to_reference(t_build(tc).init(torch.Generator().manual_seed(seed)), tc)
    if dtype != "float32":
        jc, _ = _cfgs(name, param_dtype=dtype)
        shapes = jax.eval_shape(j_build(jc).init, jax.random.PRNGKey(0))
        tree = jax.tree.map(lambda x, sd: x.astype(sd.dtype), tree, shapes)
    return tree


@functools.lru_cache(maxsize=None)
def _jax_run(name, dtype):
    """(numpy params, loss, numpy grads or None) of the JAX package's
    ``train_loss`` (its chunked attention) at the test batch; gradients in
    f32 only."""
    jc, _ = _cfgs(name, param_dtype=dtype)
    jb = j_build(jc)
    jp = jax.tree.map(jnp.asarray, _params(name, dtype))
    tok, lab = _batch(jc.vocab_size)
    batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    if dtype == "float32":
        loss, grads = jax.jit(jax.value_and_grad(jb.train_loss))(jp, batch)
        grads = jax.tree.map(np.asarray, grads)
    else:
        loss, grads = jax.jit(jb.train_loss)(jp, batch), None
    return _params(name, dtype), float(loss), grads


def _port_run(name, impl, dtype):
    _, tc = _cfgs(name, attn_impl=impl, param_dtype=dtype)
    jp, jl, jg = _jax_run(name, dtype)
    tp = params_from_reference(jp, tc)
    tok, lab = _batch(tc.vocab_size)
    batch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    return tp, t_build(tc), batch, jl, jg


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [0, 8, 16])
def test_lm_loss_chunked_with_masked_labels_matches_jax(chunk):
    """Unchunked, five whole chunks, and two chunks with a remainder."""
    rng = np.random.default_rng(1)
    h = rng.standard_normal((B, S, 24)).astype(np.float32)
    head = (rng.standard_normal((24, 50)) * 0.3).astype(np.float32)
    _, lab = _batch(50, seed=2)
    jl, (jdh, jdw) = jax.jit(jax.value_and_grad(j_layers.lm_loss, argnums=(0, 1)),
                             static_argnums=3)(jnp.asarray(h), jnp.asarray(head),
                                               jnp.asarray(lab), chunk)
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(head).requires_grad_()
    tl = t_layers.lm_loss(th, tw, torch.from_numpy(lab), chunk)
    tl.backward()
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_REL)
    assert _rel_l2(th.grad, jdh) <= GRAD_REL_L2 and _rel_l2(tw.grad, jdw) <= GRAD_REL_L2


def test_lm_loss_of_a_fully_masked_batch_is_zero():
    h = torch.randn(1, 4, 8, generator=torch.Generator().manual_seed(0))
    loss = t_layers.lm_loss(h, torch.randn(8, 5), torch.full((1, 4), -1), 2)
    assert float(loss) == 0.0


# ---------------------------------------------------------------------------
# train_loss and its gradients, leaf by leaf
# ---------------------------------------------------------------------------


#: (config, attention) pairs: flash where it is eligible; gemma3's uneven
#: windows and mamba2's absent attention take one path under either setting
#: (``test_flash_setting_is_inert_where_flash_is_not_eligible``)
CASES = [(n, impl) for n in sorted(CONFIGS) for impl in ("chunked", "flash")
         if impl == "chunked" or n not in ("gemma3-4b", "mamba2-780m")]


@pytest.mark.parametrize("name,impl", CASES)
def test_train_loss_and_gradients_match_jax_in_f32(name, impl):
    tp, tb, batch, jl, jg = _port_run(name, impl, "float32")
    loss, grads = tb.value_and_grad(tp, batch)
    np.testing.assert_allclose(float(loss), jl, rtol=LOSS_REL)
    _hold_trees(reference_tree(tp, grads), jg, GRAD_REL_L2, f"{name} {impl} gradients")


@pytest.mark.parametrize("name,impl", CASES)
def test_train_loss_matches_jax_in_bf16(name, impl):
    tp, tb, batch, jl, _ = _port_run(name, impl, "bfloat16")
    assert tp.embed.dtype == torch.bfloat16
    with torch.no_grad():
        loss = tb.train_loss(tp, batch)
    np.testing.assert_allclose(float(loss), jl, rtol=BF16_LOSS_REL)


@pytest.mark.parametrize("name", ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b"])
def test_moe_router_gradient_equals_jax_beyond_the_aux_loss(name, monkeypatch):
    """The router's top-k weights differentiate as the JAX ``route`` does
    through ``lax.top_k``: the router leaves' gradient equals JAX's in f32,
    and it is not the aux loss's share alone (the gradient with the weights'
    path cut, i.e. the aux loss's, differs from it)."""
    tp, tb, batch, _, jg = _port_run(name, "chunked", "float32")
    _, grads = tb.value_and_grad(tp, batch)
    got = reference_tree(tp, grads)["layers"]["ffn"]["router"]
    want = jg["layers"]["ffn"]["router"]
    assert _rel_l2(got, want) <= GRAD_REL_L2
    # the aux loss's share: the same loss with the router weights detached
    import repro_torch.kernels.moe_route.ops as ops

    real = ops._Route.apply

    class _Cut(torch.autograd.Function):
        @staticmethod
        def forward(ctx, logits, k, capacity):
            out = real(logits, k, capacity)
            ctx.mark_non_differentiable(*out)
            return out

    monkeypatch.setattr(ops._Route, "apply", _Cut.apply)
    _, cut = tb.value_and_grad(tp, batch)
    aux_only = reference_tree(tp, cut)["layers"]["ffn"]["router"]
    assert _rel_l2(aux_only, want) > 0.1


@pytest.mark.parametrize("name", ["gemma3-4b", "mamba2-780m"])
def test_flash_setting_is_inert_where_flash_is_not_eligible(name):
    """gemma3's local and global layers have different windows and mamba2
    has no attention: ``attn_impl="flash"`` gives the chunked path's loss
    and gradients bit for bit, in the port as in the JAX package."""
    tp, tb, batch, _, _ = _port_run(name, "chunked", "float32")
    flash = t_build(tb.cfg.with_overrides(attn_impl="flash"))
    (l0, g0), (l1, g1) = tb.value_and_grad(tp, batch), flash.value_and_grad(tp, batch)
    assert torch.equal(l0, l1) and all(torch.equal(g0[k], g1[k]) for k in g0)


def test_remat_policies_give_the_same_loss_and_gradients():
    """``remat="full"`` and ``"dots"`` recompute in the backward what
    ``"none"`` keeps: the same loss and gradients, bit for bit on the CPU,
    for a dense and an MoE model (the flash Function inside a checkpoint)."""
    for name in ("ignis-tiny", "mixtral-8x7b"):
        out = {}
        for remat in ("none", "full", "dots"):
            tp, tb, batch, _, _ = _port_run(name, "flash", "float32")
            tb = t_build(tb.cfg.with_overrides(remat=remat))
            out[remat] = tb.value_and_grad(tp, batch)
        for remat in ("full", "dots"):
            assert torch.equal(out[remat][0], out["none"][0])
            for k, g in out["none"][1].items():
                assert torch.equal(out[remat][1][k], g), (name, remat, k)


# ---------------------------------------------------------------------------
# train_step: microbatches and compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("over", [{"grad_accum": 2}, {"grad_compress": "int8"}])
def test_train_step_matches_jax(over):
    jc, tc = _cfgs("olmo-1b", param_dtype="float32", **over)
    jb, tb = j_build(jc), t_build(tc)
    tree = _params("olmo-1b", "float32", seed=1)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_reference(tree, tc)
    tok, lab = _batch(jc.vocab_size, seed=3, b=4)
    jopt = jb.init_opt(jp)
    topt = tb.init_opt(tp)
    jbatch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    tbatch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    jstep = jax.jit(jb.train_step)
    for _ in range(2):
        jp, jopt, jl = jstep(jp, jopt, jbatch)
        tp, topt, tl = tb.train_step(tp, topt, tbatch)
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_REL)
    want = jax.tree.map(np.asarray, jopt)
    got = opt_to_reference(topt, tp)
    assert int(got["step"]) == int(want["step"]) == 2
    _hold_trees(params_to_reference(tp, tc), jax.tree.map(np.asarray, jp), STEP_REL_L2,
                f"{over} params")
    for which in ("m", "v"):
        want_m = dict(_leaves(want[which]))
        for k, g in _leaves(got[which]):
            w = want_m[k].astype(np.float32)
            off = ~np.isclose(g, w, rtol=STEP_REL_L2, atol=STEP_REL_L2 * np.abs(w).max())
            assert off.sum() <= g.size * FLIPPED, f"{over} {which} {k}: {off.sum()} of {g.size}"


def test_optimizer_state_crosses_both_ways():
    jc, tc = _cfgs("mixtral-8x7b", param_dtype="bfloat16", opt_moment_dtype="bfloat16")
    jb = j_build(jc)
    jp = jax.tree.map(jnp.asarray, _params("mixtral-8x7b", "bfloat16", seed=2))
    jopt = jax.tree.map(np.asarray, jb.init_opt(jp))
    jopt["m"] = jax.tree.map(lambda m, p: (np.asarray(p, np.float32) + 1).astype(m.dtype),
                             jopt["m"], jax.tree.map(np.asarray, jp))  # nonzero, bf16
    jopt["step"] = np.int32(7)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tc)
    topt = opt_from_reference(jopt, tp)
    assert int(topt["step"]) == 7 and topt["step"].dtype == torch.int32
    back = opt_to_reference(topt, tp)
    p_back = params_to_reference(tp, tc)
    for got, want in ((back["m"], jopt["m"]), (back["v"], jopt["v"]),
                      (p_back, jax.tree.map(np.asarray, jp))):
        want = dict(_leaves(want))
        got = dict(_leaves(got))
        assert set(got) == set(want)
        for k, a in got.items():
            assert a.dtype == want[k].dtype and a.tobytes() == want[k].tobytes(), k


# ---------------------------------------------------------------------------
# the Functions' backwards against the JAX wrappers' custom vjps
# ---------------------------------------------------------------------------


def _hold(got, want, what):
    w = _f32(want)
    if got is None:  # an input the cotangent does not reach: torch's zero
        got = np.zeros_like(w)
    scale = max(float(np.abs(w).max()), 1.0)
    np.testing.assert_allclose(_f32(got), w, atol=FN_TOL * scale, rtol=FN_TOL, err_msg=what)


@pytest.mark.parametrize("kw,sq,skv", [
    (dict(causal=True), 40, 40),
    (dict(causal=True, window=8, softcap=5.0), 40, 40),
    (dict(causal=False), 24, 40),
    (dict(causal=True, q_offset=16), 24, 40),
])
def test_flash_function_backward_matches_jax(kw, sq, skv):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 4, sq, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, skv, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, skv, 16)).astype(np.float32)
    g = rng.standard_normal((2, 4, sq, 16)).astype(np.float32)
    jo, vjp = jax.vjp(lambda a, b, c: j_flash(a, b, c, kw.get("causal", True),
                                              kw.get("window"), kw.get("softcap", 0.0),
                                              kw.get("q_offset", 0)), *map(jnp.asarray, (q, k, v)))
    jd = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    # the layout the model passes: transposed views, made contiguous inside
    o = t_flash(tq, tk, tv, kw.get("causal", True), kw.get("window"), kw.get("softcap", 0.0),
                kw.get("q_offset", 0))
    o.backward(torch.from_numpy(g))
    _hold(o, jo, "out")
    for t, want, nm in zip((tq, tk, tv), jd, "qkv"):
        _hold(t.grad, want, f"d{nm}")


def test_ssd_function_backward_matches_jax_for_both_outputs():
    rng = np.random.default_rng(5)
    b, s, h, p, gr, n, chunk = 2, 48, 4, 8, 2, 8, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_log = (rng.standard_normal(h) * 0.5).astype(np.float32)
    bm = rng.standard_normal((b, s, gr, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, gr, n)).astype(np.float32)
    gy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    gs = rng.standard_normal((b, h, p, n)).astype(np.float32)
    args = (x, dt, a_log, bm, cm)
    jout, vjp = jax.vjp(lambda *a: j_ssd(*a, chunk), *map(jnp.asarray, args))
    jd = vjp((jnp.asarray(gy), jnp.asarray(gs)))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    y, st = t_ssd(*targs, chunk)
    torch.autograd.backward((y, st), (torch.from_numpy(gy), torch.from_numpy(gs)))
    _hold(y, jout[0], "y")
    _hold(st, jout[1], "state")
    for t, want, nm in zip(targs, jd, ("x", "dt", "A_log", "Bm", "Cm")):
        _hold(t.grad, want, f"d{nm}")
    # the final state's cotangent alone (the training path's y alone is the
    # model's case; the state alone exercises the other branch)
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    t_ssd(*targs, chunk)[1].backward(torch.from_numpy(gs))
    jd = vjp((jnp.zeros_like(jout[0]), jnp.asarray(gs)))
    for t, want, nm in zip(targs, jd, ("x", "dt", "A_log", "Bm", "Cm")):
        _hold(t.grad, want, f"state-only d{nm}")


@pytest.mark.parametrize("T,E,k", [(300, 8, 2), (40, 16, 2), (64, 4, 1)])
def test_router_function_backward_matches_jax_route(T, E, k):
    """``moe.route``'s weights differentiate as JAX's ``route`` (top-k
    values of the softmax, renormalised) in ``x`` and ``router``; the ids,
    ordinals and keep flags carry no gradient."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((T, 12)).astype(np.float32)
    r = rng.standard_normal((12, E)).astype(np.float32)
    g = rng.standard_normal((T, k)).astype(np.float32)
    jw, jidx, _ = j_moe.route(jnp.asarray(x), jnp.asarray(r), k)
    jd = jax.vjp(lambda a, b: j_moe.route(a, b, k)[0], jnp.asarray(x), jnp.asarray(r))[1](
        jnp.asarray(g))
    tx, tr = torch.from_numpy(x).requires_grad_(), torch.from_numpy(r).requires_grad_()
    w, idx, pos, keep, logits = t_moe.route(tx, tr, k, T)
    assert not (idx.requires_grad or pos.requires_grad or keep.requires_grad)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    w.backward(torch.from_numpy(g))
    _hold(w, jw, "w")
    _hold(tx.grad, jd[0], "dx")
    _hold(tr.grad, jd[1], "drouter")


def test_kernel_entries_refuse_a_graph_outside_their_functions():
    """On (fake) CUDA tensors that require grad, ``flash_attention_fwd`` and
    ``ssd_scan_fwd`` refuse to run under grad and name the differentiable
    entry; with no graph recorded (as inside their Functions' forwards)
    they run. (A graph on fake CUDA tensors cannot be recorded by a torch
    built without CUDA, so the Functions themselves run on the CPU here.)"""
    with FakeTensorMode():
        q = torch.empty((1, 2, 64, 64), dtype=torch.bfloat16, device="cuda",
                        requires_grad=True)
        with pytest.raises(NotImplementedError, match="ops.flash_attention"):
            flash_attention_fwd(q, q, q)
        x = torch.empty((1, 64, 2, 8), device="cuda", requires_grad=True)
        dt = torch.empty((1, 64, 2), device="cuda")
        a = torch.empty((2,), device="cuda")
        bm = torch.empty((1, 64, 1, 8), device="cuda")
        with pytest.raises(NotImplementedError, match="ops.ssd_scan"):
            ssd_scan_fwd(x, dt, a, bm, bm, 32)
        with torch.no_grad():
            assert flash_attention_fwd(q, q, q).shape == q.shape
            assert ssd_scan_fwd(x, dt, a, bm, bm, 32)[0].shape == x.shape


# ---------------------------------------------------------------------------
# launch/train: resume across packages, the command line
# ---------------------------------------------------------------------------

RUN = dict(arch="ignis-tiny", batch=2, seq_len=16, log_every=1)


def _losses(out):
    return np.array([l for _, l in out[2]])


def test_checkpoints_resume_across_packages(tmp_path):
    """A run saved by either package resumes in the other: 8 steps, then a
    16-step run from that checkpoint, by each package on a copy of the same
    directory. As in the JAX training loop, a resumed run restarts its data
    iterator, so the reference for steps 9–16 is the same package's resumed
    run, not a straight 16-step one."""
    for first in ("jax", "torch"):
        a, b = tmp_path / f"{first}_a", tmp_path / f"{first}_b"
        if first == "jax":
            j_train(steps=8, ckpt_dir=str(a), **RUN)
        else:
            t_train_mod.train(steps=8, ckpt_dir=str(a), device="cpu", **RUN)
        shutil.copytree(a, b)
        jl = j_train(steps=16, ckpt_dir=str(a), **RUN)
        tl = t_train_mod.train(steps=16, ckpt_dir=str(b), device="cpu", **RUN)
        assert [s for s, _ in jl[2]] == [s for s, _ in tl[2]] == list(range(9, 17))
        np.testing.assert_allclose(_losses(tl), _losses(jl), rtol=RESUME_REL)


def test_train_command_line_prints_a_finite_final_loss(capsys, tmp_path):
    t_train_mod.main(["--arch", "ignis-tiny", "--device", "cpu", "--steps", "8",
                      "--batch", "2", "--seq-len", "32", "--compression", "int8",
                      "--ckpt-dir", str(tmp_path), "--ckpt-every", "4"])
    out = capsys.readouterr().out.strip().splitlines()
    assert math.isfinite(json.loads(out[-1])["final_loss"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000004", "step_00000008"]


def test_train_reduces_the_loss_on_the_corpus():
    _, _, losses = t_train_mod.train(arch="ignis-tiny", steps=20, batch=4, seq_len=32,
                                     data="corpus", device="cpu", log_every=10)
    assert losses[-1][1] < losses[0][1]


# ---------------------------------------------------------------------------
# launch/train on a mesh: placements by the sharding rules, same arithmetic
# ---------------------------------------------------------------------------

MESH_RUN = dict(arch="ignis-tiny", steps=4, batch=8, seq_len=16, log_every=1)


def _with_preset(monkeypatch, preset):
    get = t_train_mod.get_config
    monkeypatch.setattr(t_train_mod, "get_config",
                        lambda arch: get(arch).with_overrides(sharding_preset=preset))


@pytest.mark.parametrize("preset", ["dp", "fsdp_tp_zero1", "tp"])
def test_train_on_a_mesh_is_the_run_without_one(monkeypatch, preset):
    """The mesh places the state over virtual ranks of the one device: the
    losses, parameters and moments are those of the run without a mesh,
    bit for bit."""
    from repro_torch.launch.mesh import make_local_mesh

    _with_preset(monkeypatch, preset)
    p0, o0, l0 = t_train_mod.train(device="cpu", **MESH_RUN)
    p1, o1, l1 = t_train_mod.train(mesh=make_local_mesh(4, 2, device="cpu"), **MESH_RUN)
    assert l0 == l1
    for (n, a), (m, b) in zip(p0.named_parameters(), p1.named_parameters(), strict=True):
        assert n == m and torch.equal(a, b), n
    for k in ("m", "v"):
        assert all(torch.equal(o0[k][n], o1[k][n]) for n in o0[k])
    assert torch.equal(o0["step"], o1["step"])


@pytest.mark.parametrize("preset", ["dp", "fsdp_tp_zero1", "tp_zero1"])
def test_train_places_by_the_reference_specs(monkeypatch, preset):
    """The placements ``train`` used are JAX's ``param_specs``/``opt_specs``
    of the same config on a (4, 2) mesh, and the batch's ``P(lead_axes)``."""
    from jax.sharding import PartitionSpec as JP

    from repro.distributed import sharding as js
    from repro_torch.launch.mesh import make_local_mesh

    _with_preset(monkeypatch, preset)
    used = []
    real = t_train_mod.train_placement

    def recording(*a, **kw):
        used.append(real(*a, **kw))
        return used[-1]

    monkeypatch.setattr(t_train_mod, "train_placement", recording)
    t_train_mod.train(mesh=make_local_mesh(4, 2, device="cpu"), **{**MESH_RUN, "steps": 1})
    (placed,) = used

    class StandIn:
        axis_names = ("data", "model")
        shape = {"data": 4, "model": 2}

    cfg = j_config(MESH_RUN["arch"]).with_overrides(sharding_preset=preset)
    jb = j_build(cfg)
    jp = jax.eval_shape(jb.init, jax.random.PRNGKey(0))
    psp = js.param_specs(jp, cfg, StandIn())
    want = {"params": psp, "opt": js.opt_specs(jax.eval_shape(jb.init_opt, jp), psp, cfg,
                                               StandIn())}
    for key in ("params", "opt"):
        got = {k: tuple(v.spec) for k, v in _leaves(placed[key])}
        assert got == {k: tuple(v) for k, v in _leaves(want[key])}, key
    lead = js.lead_axes(cfg, StandIn(), MESH_RUN["batch"], "train")
    assert tuple(placed["batch"].spec) == tuple(JP(lead, None) if lead else JP())
