"""The port's Jamba hybrid (``repro_torch.models.hybrid``) against the JAX
package's, on the reduced ``jamba-1.5-large-398b`` (one block of 8 layers:
attention, then 7 Mamba2 mixers with MoE on the odd slots; 4 experts
top-2), the weights carried across (``tests/_torch_families.py``) and the
inputs made with numpy from a seed: the forward and its aux loss, the train
loss and its gradients leaf by leaf with the chunked and the flash
attention (the flash kernel's plain version on the CPU, the JAX side's
chunked attention its oracle), prefill logits and every cache leaf, three
decode steps, one optimizer step, the serve engine at two slots against the
JAX bundle's own per-request prefill and decode, gradient compression's
grouping of stacked leaves, and ``launch.train`` checkpoints across the
packages.

Tolerances (f32): activations, logits and caches 1e-4 elementwise; loss rel
1e-5; gradients and one step's parameters rel L2 1e-4 per leaf. The engine
(f32 model, bf16 slab in both packages): decode rows within 2e-3, tokens
held where a row's top-2 margin clears twice that (a key within the f32 noise
of a bf16 rounding tie lands one ulp apart in the two slabs).
"""
import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import _torch_families as F  # noqa: E402
from repro.checkpoint import AsyncCheckpointer as JCheckpointer  # noqa: E402
from repro.checkpoint import restore as j_restore  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.models import hybrid as j_hybrid  # noqa: E402
from repro.serving.engine import _splice as j_splice  # noqa: E402
from repro_torch.distributed import compression as tcomp  # noqa: E402
from repro_torch.interop import leaf_of, params_to_reference  # noqa: E402
from repro_torch.launch import train as t_train_mod  # noqa: E402
from repro_torch.models import hybrid as t_hybrid  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

NAME = "jamba-1.5-large-398b"
B, S = 2, 40  # two SSD chunks of 16 and a remainder; an attention chunk of 32 and one
ENGINE_TOL = 2e-3
#: compression against the jitted JAX function: XLA may multiply by the
#: scale's reciprocal where the port divides, an ulp apart (a wrong grouping
#: changes the scale itself)
COMPRESS_TOL = 1e-6


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 256, (B, S)).astype(np.int32)
    lab = rng.integers(0, 256, (B, S)).astype(np.int32)
    lab[:, :3] = -1
    return {"tokens": tok, "labels": lab}


def test_reduced_config_is_one_block_with_moe_on_the_odd_slots():
    _, _, _, tp, tc = F.carried(NAME)
    assert t_hybrid._n_blocks(tc) == len(tp.blocks) == 1
    assert [t_hybrid._slot_is_moe(i, tc) for i in range(1, 8)] == [True, False] * 3 + [True]
    assert type(tp.blocks[0].s1.ffn).__name__ == "MoE"
    assert type(tp.blocks[0].s2.ffn).__name__ == "MLP"


@functools.lru_cache(maxsize=None)
def _jax_forward():
    _, jp, *_ = F.carried(NAME)
    jc, _ = F.cfgs(NAME)
    h, aux = j_hybrid.hybrid_forward(jp, jnp.asarray(_batch(1)["tokens"]), jc)
    return np.asarray(h), float(aux)


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_hybrid_forward_matches_jax(impl):
    _, _, _, tp, tc = F.carried(NAME, attn_impl=impl)
    jh, jaux = _jax_forward()
    with torch.no_grad():
        th, taux = t_hybrid.hybrid_forward(tp, torch.from_numpy(_batch(1)["tokens"]), tc)
    F.close(th, jh)
    np.testing.assert_allclose(float(taux), jaux, rtol=F.LOSS_REL)
    assert jaux > 0  # four MoE slots' balance losses


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_hybrid_train_loss_and_gradients_match_jax(impl):
    F.hold_loss_and_grads(NAME, _batch(), impl)


def test_hybrid_train_step_matches_jax():
    F.hold_train_step(NAME, _batch())


DECODE_STEPS = 3


def _decode_tokens():
    return [np.random.default_rng(3 + i).integers(0, 256, (B, 1)).astype(np.int32)
            for i in range(DECODE_STEPS)]


@functools.lru_cache(maxsize=None)
def _jax_prefill_and_decode():
    """The JAX prefill (21 tokens into a cache of 29) and three decode steps:
    [(logits, cache)] as numpy."""
    _, jp, *_ = F.carried(NAME)
    jc, _ = F.cfgs(NAME)
    logits, cache = j_hybrid.hybrid_prefill(jp, jnp.asarray(_batch(2)["tokens"][:, :21]), jc,
                                            cache_len=29)
    out = [(logits, cache)]
    step = jax.jit(lambda p, c, t: j_hybrid.hybrid_decode_step(p, c, t, jc))
    for nxt in _decode_tokens():
        logits, cache = step(jp, cache, jnp.asarray(nxt))
        out.append((logits, cache))
    return [jax.tree.map(np.asarray, o) for o in out]


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_hybrid_prefill_and_three_decode_steps_match_jax(impl):
    """Prefill into a cache of S + 8 positions (logits, k/v zero beyond S,
    the mixers' conv tails and states, pos), then three decode steps, each
    step's logits and every cache leaf."""
    _, _, _, tp, tc = F.carried(NAME, attn_impl=impl)
    want = _jax_prefill_and_decode()
    tl, tcache = t_hybrid.hybrid_prefill(tp, torch.from_numpy(_batch(2)["tokens"][:, :21]), tc,
                                         cache_len=29)
    F.close(tl, want[0][0])
    F.close_caches(tcache, want[0][1], what="prefill")
    assert tcache["conv"].shape[:3] == (1, 7, B) and tcache["state"].dtype == torch.float32
    for i, nxt in enumerate(_decode_tokens(), 1):
        tl, tcache = t_hybrid.hybrid_decode_step(tp, tcache, torch.from_numpy(nxt), tc)
        F.close(tl, want[i][0], what=f"decode {i}")
        F.close_caches(tcache, want[i][1], what=f"decode {i}")


# ---------------------------------------------------------------------------
# the engine at two slots
# ---------------------------------------------------------------------------


def _jax_rows(jb, jp, step, prompt, n, cache_len, dtypes):
    """The JAX bundle's own batch-1 prefill and ``n - 1`` decode steps of one
    request, its cache laid into a one-slot slab of the engine's leaf dtypes
    at the request's admission (``dtypes``: bf16 k, v and conv tails in a
    fresh slab; a decode step returns the conv tails promoted to f32, in
    both packages' engines): (logit rows, greedy tokens)."""
    logits, cache1 = jb.prefill(jp, tokens=jnp.asarray(prompt)[None])
    slab = {k: v.astype(dtypes[k]) for k, v in jb.make_cache(1, cache_len).items()}
    cache = j_splice(slab, cache1, 0, cache_len)
    rows = [np.asarray(logits[0], np.float32)]
    toks = [int(np.argmax(rows[-1]))]
    for _ in range(n - 1):
        logits, cache = step(jp, cache, jnp.asarray([[toks[-1]]], jnp.int32))
        rows.append(np.asarray(logits[0], np.float32))
        toks.append(int(np.argmax(rows[-1])))
    return rows, toks


def test_engine_at_two_slots_gives_each_request_the_jax_bundles_tokens():
    """Three requests through the port's engine at ``slots=2`` (the third
    admitted into a freed slot): every row the engine uses is within
    ``ENGINE_TOL`` of the JAX bundle's batch-1 prefill and decode of that
    request, up to the first near-tie the packages broke differently, and a
    token whose row clears twice that margin is held equal; the third
    request meets a slab whose conv tails the decode steps have promoted to
    f32, and its reference the same. A request whose
    mixer state landed in another slot (the JAX ``_splice``'s axis 1) would
    decode from a zero state and fail at its first decode row."""
    jb, jp, tb, tp, _ = F.carried(NAME)
    cache_len = 24
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, 256, 8, dtype=np.int32), n) for n in (5, 3, 5)]
    eng = ServeEngine(tb, tp, slots=2, cache_len=cache_len)
    rows, dtypes = {}, {}

    def prefill(params, **kw):
        logits, cache = tb.prefill(params, **kw)
        dtypes[len(rows)] = {k: str(v.dtype).split(".")[1] for k, v in eng.cache.items()}
        rows[len(rows)] = [logits[0].float().numpy()]
        return logits, cache

    def decode(*a):
        logits, cache = tb.decode_step(*a)
        for s, r in enumerate(eng.live):
            if r is not None:
                rows[r.rid].append(logits[s].float().numpy())
        return logits, cache

    eng.bundle = dataclasses.replace(tb, prefill=prefill, decode_step=decode)
    for i, (p, n) in enumerate(reqs):
        eng.submit(Request(i, p, max_new_tokens=n))
    done = {r.rid: r.tokens for r in eng.run_to_completion()}
    assert sorted(done) == [0, 1, 2]
    held = total = 0
    jstep = jax.jit(jb.decode_step)
    for rid, (p, n) in enumerate(reqs):
        jrows, jtoks = _jax_rows(jb, jp, jstep, p, n, cache_len, dtypes[rid])
        assert len(rows[rid]) == len(done[rid]) == n
        for step, (j, t) in enumerate(zip(jrows, rows[rid])):
            total += 1
            assert np.abs(j - t).max() <= ENGINE_TOL, (rid, step, np.abs(j - t).max())
            top2 = np.sort(t)[-2:]
            if top2[1] - top2[0] > 2 * ENGINE_TOL:
                assert done[rid][step] == jtoks[step], (rid, step)
                held += 1
            elif done[rid][step] != jtoks[step]:
                break
    assert held >= 0.75 * total, (held, total)


def test_engine_splices_the_mixer_state_into_its_own_slot():
    """After admitting one request into slot 1 of a two-slot slab, slot 1's
    rows equal the request's own prefill cache (k/v for its rows and zeros
    past them, conv tails, states, pos) and slot 0 is untouched; the JAX
    ``_splice`` puts the conv tails and states in slot 0 instead."""
    from repro_torch.serving.engine import _splice

    _, _, tb, tp, _ = F.carried(NAME)
    prompt = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (1, 9)).astype(np.int32))
    _, cache1 = tb.prefill(tp, tokens=prompt)
    slab = tb.make_cache(2, 16, device="cpu")
    before = {k: v.clone() for k, v in slab.items()}
    _splice(slab, cache1, 1, 16)
    for k in ("k", "v"):
        assert torch.equal(slab[k][:, 1, :9], cache1[k][:, 0].to(slab[k].dtype))
        assert not slab[k][:, 1, 9:].any()
    for k in ("conv", "state"):
        assert torch.equal(slab[k][:, :, 1], cache1[k][:, :, 0].to(slab[k].dtype))
        assert slab[k][:, :, 1].any()
    assert slab["pos"].tolist() == [0, 9]
    for k, axis in {"k": 1, "v": 1, "conv": 2, "state": 2, "pos": 0}.items():
        assert torch.equal(slab[k].select(axis, 0), before[k].select(axis, 0)), k
    jslab = j_splice({k: jnp.asarray(v.float().numpy()) for k, v in before.items()},
                     {k: jnp.asarray(v.float().numpy()) for k, v in cache1.items()}, 1, 16)
    assert np.asarray(jslab["conv"])[:, :, 0].any() and not np.asarray(jslab["conv"])[:, :, 1].any()


def test_splice_raises_where_the_layout_names_no_batch_axis():
    from repro_torch.serving.engine import _splice

    slab = {"x": torch.zeros((2, 3, 5)), "pos": torch.zeros(3, dtype=torch.int32)}
    for x in (torch.zeros((2, 1, 4)), torch.zeros((2, 1))):
        with pytest.raises(ValueError, match="batch axis"):
            _splice(slab, {"x": x, "pos": torch.zeros(1, dtype=torch.int32)}, 0, 8)


# ---------------------------------------------------------------------------
# stacked leaves: interop and compression
# ---------------------------------------------------------------------------


def test_leaf_of_names_every_stacked_prefix():
    assert leaf_of("layers.3.attn.wq") == (("layers", "attn", "wq"), 3)
    assert leaf_of("blocks.2.s3.mixer.A_log") == (("blocks", "s3", "mixer", "A_log"), 2)
    assert leaf_of("blocks.0.attn.attn.wq") == (("blocks", "attn", "attn", "wq"), 0)
    assert leaf_of("enc_layers.1.ffn.b1") == (("enc_layers", "ffn", "b1"), 1)
    assert leaf_of("dec_layers.5.cross_attn.wk") == (("dec_layers", "cross_attn", "wk"), 5)
    assert leaf_of("pos_dec") == (("pos_dec",), None)
    assert leaf_of("final_norm.scale") == (("final_norm", "scale"), None)


@pytest.mark.parametrize("name,over", [(NAME, {"num_layers": 16}),
                                       ("whisper-tiny", {})])
@pytest.mark.parametrize("method", ["int8", "topk"])
def test_compressed_grads_group_stacked_leaves_as_jax(name, over, method):
    """Gradients shaped as the model's parameters (the hybrid at two blocks,
    so its stacked leaves have two rows; whisper's two stacks): the port
    compresses per stacked JAX leaf — one int8 scale, one top-k threshold
    over every row of a path — and gives the JAX function's values and error
    feedback exactly."""
    from repro_torch.models import build_model

    _, tc = F.cfgs(name, **over)
    module = build_model(tc).init(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(4)
    g = {n: torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
         for n, p in module.named_parameters()}
    g = {n: v * (1 + int(leaf_of(n)[1] or 0)) for n, v in g.items()}  # rows of unequal scale
    tgc, tef = tcomp.compressed_grads(g, tcomp.init_ef_state(g), method)
    jg = jax.tree.map(jnp.asarray, F.grads_tree(module, g))
    jgc, jef = jax.jit(jcomp.compressed_grads, static_argnames="method")(
        jg, jcomp.init_ef_state(jg), method=method)
    got = [dict(F.leaves(F.grads_tree(module, t))) for t in (tgc, tef)]
    want = [dict(F.leaves(jax.tree.map(np.asarray, t))) for t in (jgc, jef)]
    assert got[0].keys() == want[0].keys() == got[1].keys() == want[1].keys()
    for k in want[0]:  # the jitted JAX function may land an ulp of g apart
        atol = COMPRESS_TOL * np.abs(want[0][k]).max()
        for g_, w_, what in zip(got, want, ("compressed", "error feedback")):
            np.testing.assert_allclose(g_[k], w_[k], rtol=0, atol=atol, err_msg=f"{what} {k}")
    if method == "int8":  # one scale per stacked path: every row a multiple of it
        path = next(leaf_of(n)[0] for n in g if leaf_of(n)[1] == 1)
        rows = [n for n in g if leaf_of(n)[0] == path]
        scale = max(float(g[n].abs().max()) for n in rows) / 127.0
        for n in rows:
            q = tgc[n] / scale
            assert torch.allclose(q, q.round(), atol=1e-3), n


# ---------------------------------------------------------------------------
# launch.train checkpoints across the packages
# ---------------------------------------------------------------------------

RUN = dict(arch=NAME, reduced=True, batch=2, seq_len=16, log_every=1)


def test_reduced_jamba_checkpoints_restore_across_packages(tmp_path):
    """``launch.train`` checkpoints of the reduced Jamba (bf16 weights, AdamW
    state) across the packages: a tree the JAX checkpointer writes as the
    JAX training loop does (``{"params", "opt"}``, step 2) restores in the
    port bit for bit and the port's ``train`` resumes it to step 3; a port
    run of two steps restores in the JAX package bit for bit."""
    a, b = tmp_path / "jax", tmp_path / "torch"
    cfg = t_train_mod.get_config(NAME).reduced()
    bundle = t_train_mod.build_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(9))
    jp = jax.tree.map(jnp.asarray, params_to_reference(params, cfg))
    jopt = {"m": jax.tree.map(lambda p: (p * 0.5).astype(jnp.float32), jp),
            "v": jax.tree.map(lambda p: jnp.abs(p).astype(jnp.float32) + 1e-3, jp),
            "step": jnp.asarray(2, jnp.int32)}
    ck = JCheckpointer(str(a))
    ck.save(2, {"params": jp, "opt": jopt})
    ck.wait()
    params = bundle.init(torch.Generator().manual_seed(10))
    opt = t_train_mod.restore_checkpoint(str(a), 2, params, bundle.init_opt(params))
    got = dict(F.leaves(t_train_mod.checkpoint_tree(params, opt)))
    want = {"params": jp, "opt": jopt}
    for k, w in F.leaves(jax.tree.map(np.asarray, want)):
        assert got[k].dtype == F.torch_dtype(w.dtype), k
        np.testing.assert_array_equal(got[k].float().numpy(), np.asarray(w, np.float32),
                                      err_msg=k)
    _, _, losses = t_train_mod.train(steps=3, ckpt_dir=str(a), device="cpu", **RUN)
    assert [s for s, _ in losses] == [3] and np.isfinite(losses[0][1])

    tparams, topt, _ = t_train_mod.train(steps=2, ckpt_dir=str(b), device="cpu", **RUN)
    back = j_restore(str(b), 2, want)
    saved = dict(F.leaves(t_train_mod.checkpoint_tree(tparams, topt)))
    assert int(back["opt"]["step"]) == 2
    for k, w in F.leaves(jax.tree.map(np.asarray, back)):
        np.testing.assert_array_equal(np.asarray(w, np.float32), saved[k].float().numpy(),
                                      err_msg=k)


def test_train_command_line_runs_the_reduced_jamba(capsys):
    t_train_mod.main(["--arch", NAME, "--reduced", "--device", "cpu", "--steps", "2",
                      "--batch", "2", "--seq-len", "16"])
    out = capsys.readouterr().out.strip().splitlines()
    assert np.isfinite(json.loads(out[-1])["final_loss"])
