"""The port's Whisper encoder-decoder (``repro_torch.models.encdec``) and
cross-attention (``attention(..., kv=)``) against the JAX package's, on the
reduced ``whisper-tiny`` (2 encoder and 4 decoder layers, LayerNorm, GELU
MLPs, no RoPE; position tables of 32768 as the bundles size them), the
weights carried across (``tests/_torch_families.py``) and the frames and
tokens made with numpy from a seed: cross-attention with Sq != Skv on the
chunked path and on flash (the kernel's plain version here, the Pallas
kernel in interpret mode on the JAX side), the conv frontend stub,
``encode``, ``decode_train``, the train loss and its gradients leaf by leaf,
one optimizer step, ``encdec_prefill``'s logits and cache, then three
decode steps, and the bundle's refusal of a prompt without frames (the
serve engine's, as the JAX engine's).

Tolerances (f32): activations, logits and caches 1e-4 elementwise; loss rel
1e-5; gradients and one step's parameters rel L2 1e-4 per leaf.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import _torch_families as F  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import encdec as j_encdec  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import encdec as t_encdec  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

NAME = "whisper-tiny"
B, S_ENC, S_DEC = 2, 48, 20


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    _, tc = F.cfgs(NAME)
    tok = rng.integers(0, tc.vocab_size, (B, S_DEC)).astype(np.int32)
    lab = rng.integers(0, tc.vocab_size, (B, S_DEC)).astype(np.int32)
    lab[:, :2] = -1
    frames = rng.standard_normal((B, S_ENC, tc.d_model)).astype(np.float32)
    return {"frames": frames, "tokens": tok, "labels": lab}


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_cross_attention_matches_jax(impl):
    """``attention(x, …, kv=)`` with 20 queries against 48 keys, not causal,
    with qk-norm and a RoPE theta in the config: k and v are projected from
    ``kv``, no RoPE is applied, the qk-norm is; flash runs with q_offset 0."""
    jc, tc = F.cfgs(NAME, qk_norm=True, rope_theta=10_000.0, attn_impl=impl)
    p = t_attn.Attention(tc, torch.float32, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        p.q_norm.normal_(0, 0.3, generator=torch.Generator().manual_seed(4))
        p.k_norm.normal_(0, 0.3, generator=torch.Generator().manual_seed(5))
    jp = {n: jnp.asarray(v.detach().numpy()) for n, v in p.named_parameters()}
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, S_DEC, tc.d_model)).astype(np.float32)
    kv = rng.standard_normal((B, S_ENC, tc.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S_DEC, dtype=np.int32), (B, 1))
    jo, (jk, jv) = j_attn.attention(jnp.asarray(x), jp, jc, jnp.asarray(pos),
                                    kv=jnp.asarray(kv), causal=False)
    with torch.no_grad():
        to, (tk, tv) = t_attn.attention(torch.from_numpy(x), p, tc, torch.from_numpy(pos),
                                        kv=torch.from_numpy(kv), causal=False)
    assert tuple(tk.shape) == (B, S_ENC, tc.num_kv_heads, tc.head_dim)
    F.close(to, jo)
    F.close(tk, jk)
    F.close(tv, jv)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [16, 96])
def test_conv_frontend_stub_matches_jax(width):
    """Raw features (B, S, width) pooled in pairs into (B, S/2, D): padded
    up to D when 2·width < D, cut to D otherwise."""
    jc, tc = F.cfgs(NAME)
    audio = np.random.default_rng(width).standard_normal((B, 12, width)).astype(np.float32)
    got = t_encdec.conv_frontend_stub(torch.from_numpy(audio), tc)
    want = j_encdec.conv_frontend_stub(jnp.asarray(audio), jc)
    assert tuple(got.shape) == (B, 6, tc.d_model)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@functools.lru_cache(maxsize=None)
def _jax_encode_decode():
    _, jp, *_ = F.carried(NAME)
    jc, _ = F.cfgs(NAME)
    b = _batch(1)
    enc = j_encdec.encode(jp, jnp.asarray(b["frames"]), jc)
    h = j_encdec.decode_train(jp, jnp.asarray(b["tokens"]), enc, jc)
    return np.asarray(enc), np.asarray(h)


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_encode_and_decode_train_match_jax(impl):
    """The encoder (non-causal self-attention over 48 frames) and the
    decoder's training forward (causal self-attention, then cross-attention
    on the encoder output)."""
    _, _, _, tp, tc = F.carried(NAME, attn_impl=impl)
    jenc, jh = _jax_encode_decode()
    b = _batch(1)
    with torch.no_grad():
        enc = t_encdec.encode(tp, torch.from_numpy(b["frames"]), tc)
        F.close(enc, jenc, what="encode")
        h = t_encdec.decode_train(tp, torch.from_numpy(b["tokens"]), enc, tc)
    F.close(h, jh, what="decode_train")


@pytest.mark.parametrize("frames_dtype", [torch.bfloat16, torch.float64])
def test_encode_refuses_frames_in_another_dtype(frames_dtype):
    """Frames narrower or wider than the (f32) weights are refused: the JAX
    ``encode`` would run the encoder in the wider dtype, which the port's
    matmuls do not."""
    _, _, _, tp, tc = F.carried(NAME)
    frames = torch.from_numpy(_batch(1)["frames"]).to(frames_dtype)
    with torch.no_grad(), pytest.raises(TypeError, match="cast the frames"):
        t_encdec.encode(tp, frames, tc)


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_encdec_train_loss_and_gradients_match_jax(impl):
    F.hold_loss_and_grads(NAME, _batch(), impl)


def test_encdec_train_step_matches_jax():
    F.hold_train_step(NAME, _batch())


def _decode_tokens():
    return [np.random.default_rng(7 + i).integers(0, 256, (B, 1)).astype(np.int32)
            for i in range(3)]


@functools.lru_cache(maxsize=None)
def _jax_prefill_and_decode():
    jb, jp, *_ = F.carried(NAME)
    jc, _ = F.cfgs(NAME)
    b = _batch(2)
    logits, cache = jb.prefill(jp, frames=jnp.asarray(b["frames"]),
                               tokens=jnp.asarray(b["tokens"][:, :9]))
    out = [(logits, cache)]
    # room past the prompt for the decode steps: zeros beyond it
    pad = [(0, 0), (0, 0), (0, 6), (0, 0), (0, 0)]
    cache = {**cache, "k": jnp.pad(cache["k"], pad), "v": jnp.pad(cache["v"], pad)}
    step = jax.jit(jb.decode_step)
    for nxt in _decode_tokens():
        logits, cache = step(jp, cache, jnp.asarray(nxt))
        out.append((logits, cache))
    return [jax.tree.map(np.asarray, o) for o in out]


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_encdec_prefill_then_decode_matches_jax(impl):
    """``bundle.prefill(frames=, tokens=)`` (logits, the decoder's k/v,
    ``k_cross``/``v_cross`` of the encoder output, ``pos``, ``enc_len``),
    then three decode steps against the cached cross K/V."""
    _, _, tb, tp, tc = F.carried(NAME, attn_impl=impl)
    want = _jax_prefill_and_decode()
    b = _batch(2)
    tl, tcache = tb.prefill(tp, frames=torch.from_numpy(b["frames"]),
                            tokens=torch.from_numpy(b["tokens"][:, :9]))
    F.close(tl, want[0][0])
    assert tcache["enc_len"].tolist() == [S_ENC] * B and tcache["pos"].tolist() == [9] * B
    F.close_caches(tcache, want[0][1], what="prefill")
    pad = (0, 0, 0, 0, 0, 6)
    tcache = {**tcache, "k": torch.nn.functional.pad(tcache["k"], pad),
              "v": torch.nn.functional.pad(tcache["v"], pad)}
    for i, nxt in enumerate(_decode_tokens(), 1):
        tl, tcache = tb.decode_step(tp, tcache, torch.from_numpy(nxt))
        F.close(tl, want[i][0], what=f"decode {i}")
        F.close_caches(tcache, want[i][1], what=f"decode {i}")


def test_audio_prompts_need_frames_as_in_the_jax_engine():
    """The bundle's prefill needs ``frames``; the serve engine feeds token
    prompts only, so an audio request raises there (the JAX bundle's
    ``inp["frames"]``), with a message naming the bundle's entry."""
    _, _, tb, tp, _ = F.carried(NAME)
    with pytest.raises(KeyError, match="frames"):
        tb.prefill(tp, tokens=torch.zeros((1, 4), dtype=torch.int32))
    eng = ServeEngine(tb, tp, slots=2, cache_len=16)
    eng.submit(Request(0, np.arange(4, dtype=np.int32), max_new_tokens=2))
    with pytest.raises(KeyError, match="bundle.prefill"):
        eng.run_to_completion()
