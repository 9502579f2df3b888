"""The decode attention kernel's wrapper, its plain version and the decode
step that dispatches to them.

On the CPU the wrapper takes the plain version (the masked ``attend`` over
the whole cache), so a decode step gives the same numbers bit for bit
whatever ``attn_impl`` says; the first tests hold that against a copy of
the decode attention as it was before the kernel existed. Calls on fake
CUDA tensors run the launch's checks and price as one kernel call. The
tests marked ``cuda`` hold the CUDA kernel against the plain version on a
card and skip without one (``pytest -m cuda tests/test_torch_decode_attention.py``
on the card).
"""
import importlib
import itertools
import os
import re
import sys

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import kernels
from repro_torch.configs import ShapeCell, get_config
from repro_torch.kernels import _cuda, recording_calls
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
from repro_torch.models import attention as A
from repro_torch.models import build_model
from repro_torch.models.layers import rmsnorm, rope
from repro_torch.profile import cost
from repro_torch.profile.cost import CostEstimate, CostModel

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from chip_smoke import DECODE_REL_L2, DECODE_TOL  # noqa: E402

da = importlib.import_module("repro_torch.kernels.decode_attention.decode_attention")

SMAX = 24


def _seed_decode_attention(x, p, cfg, pos, k_cache, v_cache, *, window=A.GLOBAL_WINDOW):
    """The decode attention before the kernel, line for line: the new row
    written at the clamped position, then ``attend`` over the whole cache
    with the rows past ``pos`` masked."""
    B = x.shape[0]
    q = (x @ p.wq).reshape(B, 1, cfg.num_heads, cfg.head_dim)
    k_new = (x @ p.wk).reshape(B, 1, cfg.num_kv_heads, cfg.head_dim)
    v_new = (x @ p.wv).reshape(B, 1, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm)
        k_new = rmsnorm(k_new, p.k_norm)
    if cfg.rope_theta:
        q = rope(q, pos[:, None], cfg.rope_theta)
        k_new = rope(k_new, pos[:, None], cfg.rope_theta)

    Smax = k_cache.shape[1]
    rows = torch.arange(B, device=x.device)
    at = pos.long().clamp(0, Smax - 1)
    k_cache[rows, at] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, at] = v_new[:, 0].to(v_cache.dtype)

    idx = torch.arange(Smax, device=x.device, dtype=torch.int32)[None, :]
    pos_kv = torch.where(idx <= pos[:, None], idx, -1)
    o = A.attend(q, k_cache, v_cache, pos[:, None], pos_kv, window=window, causal=True,
                 cap=cfg.attn_logit_softcap, chunk=0)
    return A._promote(o.reshape(B, 1, cfg.q_dim), p.wo), k_cache, v_cache


def _cfg(G, hd, dtype, cap=0.0, qk_norm=False, impl="chunked"):
    K = 2
    return get_config("olmo-1b").reduced().with_overrides(
        d_model=64, num_heads=K * G, num_kv_heads=K, head_dim=hd, qk_norm=qk_norm,
        attn_logit_softcap=cap, param_dtype=dtype, attn_impl=impl)


def _layer(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    dt = getattr(torch, cfg.param_dtype)
    p = A.Attention(cfg, dt, generator=g)
    if cfg.qk_norm:
        with torch.no_grad():
            p.q_norm.normal_(generator=g)
            p.k_norm.normal_(generator=g)
    return p


def _slab(cfg, B, seed):
    rng = np.random.default_rng(seed)
    shape = (B, SMAX, cfg.num_kv_heads, cfg.head_dim)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
            for _ in range(2)]


#: ragged positions: the first row, inside, the last row, past the end
#: (the write clamps to the last row; every row is live)
POS = [0, 5, SMAX - 1, SMAX + 3]
CASES = [  # (G, hd, param dtype, window, softcap, qk_norm)
    (1, 128, "bfloat16", A.GLOBAL_WINDOW, 0.0, False),  # OLMo-1B's shape
    (5, 128, "bfloat16", A.GLOBAL_WINDOW, 0.0, True),  # Qwen3's G and qk-norm
    (8, 128, "bfloat16", 7, 0.0, False),  # Yi's G, a window
    (2, 256, "bfloat16", 4, 50.0, False),  # Gemma3: hd 256, a local window, soft-cap
    (7, 64, "bfloat16", A.GLOBAL_WINDOW, 0.0, False),  # InternVL2: hd 64
    (1, 64, "float32", A.GLOBAL_WINDOW, 0.0, False),  # an f32 model over the bf16 slab
    (5, 256, "float32", 3, 30.0, True),
]


@pytest.mark.parametrize("impl", ["chunked", "flash"])
@pytest.mark.parametrize("G,hd,dtype,window,cap,qk_norm", CASES)
def test_decode_attention_equals_the_seed_bit_for_bit(G, hd, dtype, window, cap, qk_norm,
                                                       impl):
    """On the CPU, both ``attn_impl``s give the output and the written
    caches of the decode attention before the kernel, bit for bit."""
    cfg = _cfg(G, hd, dtype, cap, qk_norm, impl)
    p = _layer(cfg, G * hd)
    B = len(POS)
    x = torch.randn((B, 1, cfg.d_model), generator=torch.Generator().manual_seed(hd)).to(
        getattr(torch, dtype))
    pos = torch.tensor(POS, dtype=torch.int32)
    kernels.reset_launches()
    with torch.no_grad():
        k1, v1 = _slab(cfg, B, G)
        got, gk, gv = A.decode_attention(x, p, cfg, pos, k1, v1, window=window)
        k2, v2 = _slab(cfg, B, G)
        want, wk, wv = _seed_decode_attention(x, p, cfg, pos, k2, v2, window=window)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want) and torch.equal(gk, wk) and torch.equal(gv, wv)
    assert gk is k1 and gv is v1  # written in place
    assert kernels.launch_counters()["decode_attention"].launches == 0


def test_a_decode_step_through_the_engine_is_the_same_under_either_impl():
    """A whole reduced model's decode step (the engine's slab, bf16) gives
    the same logits with ``attn_impl`` flash and chunked on the CPU."""
    cfg = get_config("olmo-1b").reduced()
    out = {}
    for impl in ("chunked", "flash"):
        bundle = build_model(cfg.with_overrides(attn_impl=impl), device="cpu")
        params = bundle.init(torch.Generator().manual_seed(0))
        cache = bundle.make_cache(3, SMAX, device="cpu")
        cache["pos"] = torch.tensor([0, 9, SMAX - 1], dtype=torch.int32)
        tokens = torch.tensor([[1], [2], [3]], dtype=torch.int32)
        out[impl] = bundle.decode_step(params, cache, tokens)[0]
    assert torch.equal(out["chunked"], out["flash"])


def test_the_split_count_follows_the_pairs_against_the_sms():
    """No split at the serve cell's 128 slots x 16 kv heads; a split where
    the (slot, kv head) pairs leave SMs without a block, never shorter than
    ``MIN_SPLIT_ROWS`` rows of the slab."""
    assert da.splits(128, 16, 2048, 132) == 1 and da.variant(1) == "whole"
    assert da.splits(33, 4, 4096, 132) == 1
    n = da.splits(4, 8, 4096, 132)
    assert n == 9 and da.variant(n) == "split"  # two blocks an SM
    assert da.splits(4, 1, 4096, 132) == da.MAX_SPLITS
    assert da.splits(1, 1, 256, 132) == 256 // da.MIN_SPLIT_ROWS
    assert da.splits(1, 1, 64, 132) == 1


def test_the_counter_is_registered_and_cpu_calls_count_no_launch():
    kernels.reset_launches()
    fn = kernels.launch_counters()["decode_attention"]
    assert fn is da.decode_attention_fwd is decode_attention
    cfg = _cfg(1, 64, "bfloat16")
    k, v = _slab(cfg, 2, 0)
    decode_attention(torch.zeros((2, 1, 2, 64), dtype=torch.bfloat16), k, v,
                     torch.tensor([3, 30], dtype=torch.int32))
    assert fn.launches == fn.tune_launches == 0 and fn.launches_by_variant == {}
    assert not fn.geometries


def test_the_source_includes_the_shared_header_and_names_no_flash_kernel():
    """The kernel's source states that it replaces no TPU kernel, includes
    ``sm90.cuh`` and names no kernel ``flash*`` (the benchmark's flash
    roofline sums the device time of every kernel so named)."""
    src = (_cuda.CSRC / "decode_attention.cu").read_text()
    assert "Replaces no TPU kernel" in src and '#include "sm90.cuh"' in src
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\(\w+\)\s+)?(\w+)", src)
    assert names and not any(n.startswith("flash") for n in names)
    assert _cuda.library_path("decode_attention").name.startswith("decode_attention-")


# ---------------------------------------------------------------------------
# fake tensors: the launch's checks, and the price of one call
# ---------------------------------------------------------------------------


def _fake_cuda(*specs):
    with FakeTensorMode():
        return [torch.empty(shape, dtype=dt, device="cuda") for shape, dt in specs]


BF, F32, I32 = torch.bfloat16, torch.float32, torch.int32


def _specs(B=2, H=4, K=2, Smax=32, hd=128, q=BF, kv=BF, pos=I32):
    return [((B, 1, H, hd), q), ((B, Smax, K, hd), kv), ((B, Smax, K, hd), kv), ((B,), pos)]


REFUSED = {
    "a float32 slab": _specs(kv=F32),
    "a float16 query": _specs(q=torch.float16),
    "int64 positions": _specs(pos=torch.int64),
    "head_dim 96": _specs(hd=96),
    "head_dim 32": _specs(hd=32),
    "16 query heads a kv head": _specs(H=32),
    "H not a multiple of K": _specs(H=5),
    "two query tokens": [((2, 2, 4, 128), BF)] + _specs()[1:],
    "k and v of other shapes": _specs()[:2] + [((2, 16, 2, 128), BF), ((2,), I32)],
    "positions of another batch": _specs()[:3] + [((3,), I32)],
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_the_wrapper_refuses_what_the_kernel_cannot_run(name):
    args = _fake_cuda(*REFUSED[name])
    with pytest.raises(ValueError):
        decode_attention(*args)


def test_the_wrapper_refuses_a_strided_slab_and_a_bad_window():
    q, k, v, pos = _fake_cuda(*_specs())
    B, Smax, K, hd = k.shape
    with FakeTensorMode():  # (B, Smax, K, hd) laid out as (B, K, Smax, hd)
        kt = torch.empty_strided(k.shape, (K * Smax * hd, hd, Smax * hd, 1), dtype=BF,
                                 device="cuda")
    assert kt.shape == k.shape and not kt.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention(q, kt, v, pos)
    with pytest.raises(ValueError, match="window"):
        decode_attention(q, k, v, pos, window=0)
    with pytest.raises(ValueError, match="softcap"):
        decode_attention(q, k, v, pos, softcap=-1.0)


def test_a_call_on_fake_cuda_tensors_prices_as_one_kernel_call():
    """q, the slab and pos read once, o written once, 4·hd·B·H FLOP a key
    over every row a window leaves (the positions are data); nothing
    launches. The same call on fake CPU tensors prices the same."""
    kernels.reset_launches()
    B, H, K, Smax, hd = 2, 4, 2, 32, 128
    args = _fake_cuda(*_specs(B, H, K, Smax, hd))
    want = CostEstimate(4 * hd * B * H * Smax,
                        2 * B * H * hd * 2 + 2 * B * Smax * K * hd * 2 + B * 4, 0.0, 1.0)
    assert CostModel().price_fn(lambda *t: decode_attention(*t), *args) == want
    windowed = CostModel().price_fn(lambda *t: decode_attention(*t, window=8), *args)
    assert windowed.flops == 4 * hd * B * H * 8
    with recording_calls() as calls:
        decode_attention(*args)
    assert [(c.kernel, c.count) for c in calls] == [("decode_attention", 1)]
    with FakeTensorMode():
        cpu = [torch.empty(s, dtype=d) for s, d in _specs(B, H, K, Smax, hd)]
    assert CostModel().price_fn(lambda *t: decode_attention(*t), *cpu) == want
    assert all(fn.launches == fn.tune_launches == 0
               for fn in kernels.launch_counters().values())


def test_a_flash_decode_step_prices_one_kernel_call_a_layer():
    """The dry run's pricing by layer signature of a flash decode step
    equals the unrolled trace, with one decode kernel call a layer."""
    from repro_torch.launch import dryrun

    cfg = get_config("olmo-1b").reduced().with_overrides(attn_impl="flash")
    bundle = build_model(cfg, device="cpu")
    cell = ShapeCell("d", 96, 4, "decode")
    fn, args = bundle.step_for_cell(cell)
    gm = cost.trace(lambda c, t: fn(args[0], c, t), *args[1:])
    unrolled = cost.CostModel().price_graph(gm)
    calls = {}
    for c in gm.meta["kernel_calls"]:
        calls[c.kernel] = calls.get(c.kernel, 0) + c.count
    assert calls == {"decode_attention": cfg.num_layers}
    priced = dryrun.price_step(bundle, cell, args[0], {"cache": args[1], "tokens": args[2]})
    assert priced["act"] + priced["opt"] == unrolled
    assert priced["calls"] == calls


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

#: every GQA group the kernel has an instance for (the configs': Qwen3 5, Yi
#: and Jamba 8, InternVL2 7, Gemma3 2, Mixtral and Phi 4)
EDGE_G = tuple(range(1, 9))
EDGE_WINDOWS = (A.GLOBAL_WINDOW, 16, 1024)
#: both routes: ``whole`` (34 slots x 4 kv heads, more pairs than SMs) and
#: ``split`` (3 slots x 2 kv heads), over a slab of 600 rows
ROUTES = [("whole", 34, 4), ("split", 3, 2)]
EDGE_SMAX = 600


def _on_card(B, Smax, K, G, hd, qdt, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = (torch.randn((B, 1, K * G, hd), generator=g, device="cuda") * 4).to(qdt)
    k = torch.randn((B, Smax, K, hd), generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn((B, Smax, K, hd), generator=g, device="cuda").to(torch.bfloat16)
    return q, k, v


def _ragged_pos(Smax, B):
    """The first row, one row, a block's worth and more, the last row, past
    the end (clamped: every row live), cycled over ``B`` slots."""
    return torch.tensor(([0, 1, 37, 300, Smax - 1, Smax + 5] * B)[:B], dtype=torch.int32,
                        device="cuda")


def _held(got, want, what):
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape, what
    assert not torch.isnan(got).any(), what
    atol, rtol = DECODE_TOL  # chip_smoke.py's, which gives the reasons
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol, msg=what)
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    assert rel <= DECODE_REL_L2, f"{what}: relative L2 {rel}"


@pytest.mark.cuda
@pytest.mark.parametrize("route,B,K", ROUTES)
@pytest.mark.parametrize("G,hd,qdt,window,cap", [
    *itertools.product(EDGE_G, (64, 128, 256), (torch.bfloat16, torch.float32), EDGE_WINDOWS,
                       (0.0, 50.0)),
    (5, 128, torch.bfloat16, 100, 0.0), (2, 256, torch.bfloat16, 33, 50.0),
    (4, 128, torch.float32, A.GLOBAL_WINDOW, 30.0)])
def test_the_kernel_equals_the_plain_version_on_either_route(card, route, B, K, G, hd, qdt,
                                                             window, cap):
    q, k, v = _on_card(B, EDGE_SMAX, K, G, hd, qdt, G * hd)
    pos = _ragged_pos(EDGE_SMAX, B)
    fn = da.decode_attention_fwd
    before = fn.launches_by_variant.get(route, 0)
    with torch.no_grad():
        got = decode_attention(q, k, v, pos, window=window, softcap=cap)
        want = decode_attention_ref(q, k, v, pos, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert fn.launches_by_variant.get(route, 0) == before + 1
    _held(got, want, f"{route} G={G} hd={hd} {qdt} window={window} softcap={cap}")


@pytest.mark.cuda
@pytest.mark.parametrize("B,Smax,K,at", [(4, 256, 2, (0, 17, 128, 200)),
                                         *((B, EDGE_SMAX, K, None) for _, B, K in ROUTES)])
def test_the_kernel_reads_only_the_live_rows(card, B, Smax, K, at):
    """Rows past ``pos`` may hold anything: NaNs there change nothing (on
    both routes at the edge cases' ragged positions)."""
    q, k, v = _on_card(B, Smax, K, 1, 128, torch.bfloat16, 7)
    pos = (torch.tensor(at, dtype=torch.int32, device="cuda") if at
           else _ragged_pos(Smax, B))
    with torch.no_grad():
        clean = decode_attention(q, k, v, pos)
        for b, p in enumerate(pos.tolist()):
            k[b, p + 1:] = float("nan")
            v[b, p + 1:] = float("nan")
        dirty = decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert torch.equal(clean, dirty)
