"""The port's VLM patch prefix (``repro_torch.models.transformer`` with
``frontend="vit_patch"``) against the JAX package's, on the reduced
``internvl2-1b`` (4 layers, tied embeddings, 8 patches of width
``VIT_DIM``), the weights carried across (``tests/_torch_families.py``) and
the tokens and patches made with numpy from a seed: ``embed_tokens`` with
patches, the train loss with its masked prefix and its gradients leaf by
leaf with the chunked and the flash attention (the flash kernel's plain
version on the CPU; the JAX side's chunked attention its oracle),
``lm_prefill(patches=)`` then ``lm_decode_step``, one optimizer step, and
the serve engine text-only against the JAX engine, as the JAX engine serves
the VLM.

Tolerances (f32): activations, logits and caches 1e-4 elementwise; loss rel
1e-5; gradients and one step's parameters rel L2 1e-4 per leaf; the engines'
rows 1e-4 (``tests/test_torch_serving.py``'s rule).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import _torch_families as F  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.models.model_zoo import VIT_DIM  # noqa: E402
from test_torch_serving import _engines_agree, _requests  # noqa: E402

NAME = "internvl2-1b"
B, S_TEXT = 2, 30


def _batch(seed=0, s=S_TEXT):
    rng = np.random.default_rng(seed)
    _, tc = F.cfgs(NAME)
    tok = rng.integers(0, tc.vocab_size, (B, s)).astype(np.int32)
    lab = rng.integers(0, tc.vocab_size, (B, s)).astype(np.int32)
    lab[:, :2] = -1
    patches = rng.standard_normal((B, tc.num_patches, VIT_DIM)).astype(np.float32)
    return {"tokens": tok, "labels": lab, "patches": patches}


def test_vit_proj_is_a_parameter_of_the_vlm_only():
    _, _, _, tp, tc = F.carried(NAME)
    assert tc.frontend == "vit_patch" and tc.num_patches == 8 and VIT_DIM == 1024
    assert tuple(tp.vit_proj.shape) == (VIT_DIM, tc.d_model)
    assert "vit_proj" in F.tree(NAME)
    assert not hasattr(t_tf.TransformerLM(F.cfgs("qwen3-14b")[1], device="meta"), "vit_proj")


def test_embed_tokens_prepends_the_projected_patches_as_jax():
    jb, jp, _, tp, tc = F.carried(NAME)
    jc, _ = F.cfgs(NAME)
    b = _batch(1)
    want = j_tf.embed_tokens(jp, jnp.asarray(b["tokens"]), jc, jnp.asarray(b["patches"]))
    with torch.no_grad():
        got = t_tf.embed_tokens(tp, torch.from_numpy(b["tokens"]), tc,
                                torch.from_numpy(b["patches"]))
    assert got.shape == (B, tc.num_patches + S_TEXT, tc.d_model)
    F.close(got, want)
    # bf16 patches are cast to the activations' dtype first, as in JAX
    with torch.no_grad():
        got16 = t_tf.embed_tokens(tp, torch.from_numpy(b["tokens"]), tc,
                                  torch.from_numpy(b["patches"]).bfloat16())
    want16 = j_tf.embed_tokens(jp, jnp.asarray(b["tokens"]), jc,
                               jnp.asarray(b["patches"], jnp.bfloat16))
    assert got16.dtype == torch.float32
    F.close(got16, want16)


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_vlm_train_loss_with_the_masked_prefix_and_gradients_match_jax(impl):
    F.hold_loss_and_grads(NAME, _batch(), impl)


def test_vlm_loss_takes_nothing_from_the_prefix_positions():
    """The prefix carries no label: the loss equals the text positions' mean
    cross-entropy of the same hidden states, whatever the prefix's logits."""
    from repro_torch.models.layers import lm_loss

    _, _, tb, tp, tc = F.carried(NAME)
    b = {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    with torch.no_grad():
        loss = tb.train_loss(tp, b)
        h, _ = t_tf.lm_forward(tp, b["tokens"], tc, b["patches"])
        text = lm_loss(h[:, tc.num_patches:], t_tf.head_matrix(tp, tc), b["labels"])
    torch.testing.assert_close(loss, text, rtol=1e-6, atol=0)


def test_vlm_train_step_matches_jax():
    F.hold_train_step(NAME, _batch())


@functools.lru_cache(maxsize=None)
def _jax_prefill_and_decode():
    _, jp, *_ = F.carried(NAME)
    jc, _ = F.cfgs(NAME)
    b = _batch(3, s=13)
    logits, cache = j_tf.lm_prefill(jp, jnp.asarray(b["tokens"]), jc, cache_len=28,
                                    patches=jnp.asarray(b["patches"]))
    out = [(logits, cache)]
    step = jax.jit(lambda p, c, t: j_tf.lm_decode_step(p, c, t, jc))
    for nxt in _decode_tokens():
        logits, cache = step(jp, cache, jnp.asarray(nxt))
        out.append((logits, cache))
    return [jax.tree.map(np.asarray, o) for o in out]


def _decode_tokens():
    return [np.random.default_rng(4 + i).integers(0, 256, (B, 1)).astype(np.int32)
            for i in range(3)]


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_prefill_with_patches_then_decode_matches_jax(impl):
    """``lm_prefill(patches=)`` of 8 patches and 13 tokens into a cache of
    28 (positions and ``pos`` span the prefix), then three decode steps:
    logits and every cache leaf each time."""
    _, _, _, tp, tc = F.carried(NAME, attn_impl=impl)
    want = _jax_prefill_and_decode()
    b = _batch(3, s=13)
    tl, tcache = t_tf.lm_prefill(tp, torch.from_numpy(b["tokens"]), tc, cache_len=28,
                                 patches=torch.from_numpy(b["patches"]))
    assert tcache["pos"].tolist() == [tc.num_patches + 13] * B
    F.close(tl, want[0][0])
    F.close_caches(tcache, want[0][1], what="prefill")
    for i, nxt in enumerate(_decode_tokens(), 1):
        tl, tcache = t_tf.lm_decode_step(tp, tcache, torch.from_numpy(nxt), tc)
        F.close(tl, want[i][0], what=f"decode {i}")
        F.close_caches(tcache, want[i][1], what=f"decode {i}")


def test_bundle_prefill_takes_patches():
    _, _, tb, tp, tc = F.carried(NAME)
    b = _batch(5, s=6)
    tok, pat = torch.from_numpy(b["tokens"]), torch.from_numpy(b["patches"])
    logits, cache = tb.prefill(tp, tokens=tok, patches=pat, cache_len=20)
    want, _ = t_tf.lm_prefill(tp, tok, tc, cache_len=20, patches=pat)
    assert torch.equal(logits, want) and cache["k"].shape[2] == 20


def test_engine_serves_the_vlm_text_only_as_the_jax_engine():
    """The JAX engine prefills token prompts only (``bundle.prefill(params,
    tokens=…)``): the VLM is served text-only there, and the port's engine
    gives the same rows and tokens."""
    jb, jp, tb, tp, tc = F.carried(NAME)
    _, held, total = _engines_agree(jb, jp, tb, tp, _requests(8, tc.vocab_size, n=4), slots=2)
    assert held == total
