"""The flash attention backward: the kernel ``flash_attention_bwd`` on the
``wgmma`` route, and the Function's choice between it and the plain vjp.

On the CPU the Function's backward is ``attention_ref``'s vjp, bit for bit
as before the kernel; calls on fake CUDA tensors run the backward launch's
checks and price as one kernel call. The tests marked ``cuda`` hold the
kernel against the plain vjp on a card and skip without one (``pytest -m
cuda tests/test_torch_flash_backward.py`` on the card).
"""
import importlib
import pathlib
import re

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import kernels
from repro_torch.kernels import recording_calls
from repro_torch.kernels.flash_attention import attention_ref, flash_attention

fa = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
ops = importlib.import_module("repro_torch.kernels.flash_attention.ops")

CU = pathlib.Path(fa.__file__).resolve().parents[2] / "csrc" / "flash_attention.cu"

MASKS = [  # (Sq, Skv, causal, window, softcap, q_offset)
    (9, 9, True, None, 0.0, 0),
    (7, 20, True, 5, 0.0, 13),
    (20, 7, False, None, 30.0, 0),
    (16, 16, False, 4, 0.0, 0),
]


def _inputs(seed, B, H, K, Sq, Skv, hd, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
            for s in ((B, H, Sq, hd), (B, K, Skv, hd), (B, K, Skv, hd), (B, H, Sq, hd))]


def _plain_grads(q, k, v, g, **kw):
    xs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(attention_ref(*xs, **kw), xs, g)


# ---------------------------------------------------------------------------
# the CPU: the plain vjp, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv,causal,window,cap,off", MASKS)
def test_the_cpu_backward_is_the_plain_vjp_bit_for_bit(dtype, Sq, Skv, causal, window, cap,
                                                       off):
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=off)
    q, k, v, g = _inputs(Sq * 31 + Skv, 2, 4, 2, Sq, Skv, 16, dtype)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention(*xs, **kw).backward(g)
    for got, want in zip((x.grad for x in xs), _plain_grads(q, k, v, g, **kw), strict=True):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_the_cpu_backward_entry_is_the_plain_vjp_and_counts_no_launch():
    kw = dict(causal=True, window=None, softcap=0.0, q_offset=0)
    q, k, v, g = _inputs(3, 1, 2, 1, 12, 12, 16, torch.float32)
    fn = kernels.launch_counters()["flash_attention_bwd"]
    assert fn is fa.flash_attention_bwd
    before = (fn.launches, fn.tune_launches, dict(fn.launches_by_variant))
    got = fa.flash_attention_bwd(q, k, v, None, None, g, **kw)
    for a, b in zip(got, _plain_grads(q, k, v, g, **kw), strict=True):
        assert torch.equal(a, b)
    assert (fn.launches, fn.tune_launches, dict(fn.launches_by_variant)) == before


# ---------------------------------------------------------------------------
# fake CUDA tensors: the route, the refusals, the price
# ---------------------------------------------------------------------------


class _Ctx:
    """What ``_Flash.forward`` and ``backward`` read of autograd's context,
    so the Function's steps run on fake CUDA tensors without a graph (a
    torch built without CUDA aborts when autograd records one)."""

    def __init__(self, needs):
        self.needs_input_grad = needs
        self.saved_tensors = ()

    def save_for_backward(self, *ts):
        self.saved_tensors = ts


@pytest.mark.parametrize("dtype,hd,kernel", [(torch.bfloat16, 64, True),
                                             (torch.bfloat16, 128, True),
                                             (torch.bfloat16, 256, False),
                                             (torch.float32, 128, False)])
def test_the_backward_route_follows_variant(dtype, hd, kernel):
    with FakeTensorMode(), torch.no_grad():
        q = torch.empty((2, 4, 130, hd), dtype=dtype, device="cuda")
        k = torch.empty((2, 2, 130, hd), dtype=dtype, device="cuda")
        assert ops.kernel_backward(q) is kernel
        assert (fa.variant(dtype, hd) == "wgmma") is kernel
        ctx = _Ctx((True, True, True, False, False, False, False))
        o = ops._Flash.forward(ctx, q, k, k, True, None, 0.0, 0)
        assert o.shape == q.shape
        assert len(ctx.saved_tensors) == (5 if kernel else 3)
        if kernel:
            lse = ctx.saved_tensors[4]
            assert lse.dtype == torch.float32 and lse.shape == (2, 4, 256)
            with recording_calls() as calls:
                dq, dk, dv = ops._Flash.backward(ctx, torch.empty_like(o))[:3]
            assert [c.kernel for c in calls] == ["flash_attention_bwd"]
            assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
        # no gradient wanted: the serve path's forward, nothing saved beyond (q, k, v)
        ctx = _Ctx((False, False, False, False, False, False, False))
        ops._Flash.forward(ctx, q, k, k, True, None, 0.0, 0)
        assert len(ctx.saved_tensors) == 3


def _fake_args(mode, B=2, H=4, K=2, Sq=130, Skv=130, hd=128, dtype=torch.bfloat16,
               lse_rows=None):
    with mode:
        q = torch.empty((B, H, Sq, hd), dtype=dtype, device="cuda")
        k = torch.empty((B, K, Skv, hd), dtype=dtype, device="cuda")
        lse = torch.empty((B, H, lse_rows or fa.lse_rows(Sq)), device="cuda")
    return q, k, k, q, lse, q


@pytest.mark.parametrize("Sq,Skv,causal,window,off", [(130, 130, True, None, 0),
                                                      (448, 1500, False, None, 0),
                                                      (7, 200, True, 33, 193),
                                                      (1, 1, True, None, 0)])
@pytest.mark.parametrize("G,hd", [(1, 128), (7, 64), (8, 128)])
def test_a_fake_cuda_call_is_priced_as_one_kernel_call(Sq, Skv, causal, window, off, G, hd):
    mode = FakeTensorMode()
    args = _fake_args(mode, B=2, H=2 * G, K=2, Sq=Sq, Skv=Skv, hd=hd)
    fn = fa.flash_attention_bwd
    before = fn.launches
    with mode, recording_calls() as calls:
        dq, dk, dv = fn(*args, causal=causal, window=window, q_offset=off)
    assert fn.launches == before
    assert dq.shape == args[0].shape and dk.shape == dv.shape == args[1].shape
    (call,) = calls
    pairs = fa.live_pairs(Sq, Skv, causal, window, off)
    assert call.kernel == "flash_attention_bwd" and call.count == 1
    assert call.flops == 10 * hd * 2 * (2 * G) * pairs
    # each operand read once, each gradient written once
    nbytes = sum(t.numel() * t.element_size() for t in (*args, dq, dk, dv))
    assert call.bytes == nbytes


def test_the_backward_refuses_what_it_cannot_launch():
    mode = FakeTensorMode()
    fn = fa.flash_attention_bwd
    q, k, v, o, lse, do = _fake_args(mode)
    with mode:
        f32 = [t.float() for t in (q, k, v, o, do)]
        cases = {
            "bfloat16 q, k, v, o, dO": ((*f32[:4], lse, f32[4]), {}),
            "float32 log-sum-exp": ((q, k, v, o, lse.bfloat16(), do), {}),
        }
        q256, k256, _, _, lse256, _ = _fake_args(mode, hd=256)
        cases["head_dim"] = ((q256, k256, k256, q256, lse256, q256), {})
        def e(shape, dtype=torch.bfloat16):  # a fake CUDA view cannot be sliced
            return torch.empty(shape, dtype=dtype, device="cuda")

        q3 = e((2, 3, 130, 128))
        cases["multiple of K"] = ((q3, k, v, q3, e((2, 3, 256), torch.float32), q3), {})
        cases["q = o = dO"] = ((q, k, v, e((2, 4, 129, 128)), lse, do), {})
        cases["k = v"] = ((q, k, e((2, 2, 129, 128)), o, lse, do), {})
        cases["expected"] = ((q, k, v, o, e((2, 4, 130), torch.float32), do), {})  # unpadded
        cases["window"] = ((q, k, v, o, lse, do), {"window": 0})
        cases["q_offset"] = ((q, k, v, o, lse, do), {"q_offset": -1})
        for match, (args, kw) in cases.items():
            with pytest.raises(ValueError, match=match):
                fn(*args, **kw)
        cpu = torch.empty((2, 4, 130, 128), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="CUDA device"):
            fn(q, k, v, cpu, lse, do)


def test_the_backward_refuses_unaligned_operands(monkeypatch):
    """The alignment reads addresses, which fake tensors lack: the check runs
    on CPU tensors here, with the device check waved through."""
    monkeypatch.setattr(fa, "require_cuda", lambda *ts: None)
    q = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 1, 8, 64), dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, fa.lse_rows(8)))
    fa._check_bwd(q, k, k, q, lse, q, 0, None, 0.0)
    odd = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte"):
        fa._check_bwd(q, k, k, odd, lse, q, 0, None, 0.0)


def test_the_forward_writes_the_lse_only_on_the_wgmma_route():
    mode = FakeTensorMode()
    with mode, torch.no_grad():
        q = torch.empty((1, 2, 130, 128), dtype=torch.bfloat16, device="cuda")
        o, lse = fa.flash_attention_fwd(q, q, q, with_lse=True)
        assert o.shape == q.shape and lse.shape == (1, 2, 256) and lse.dtype == torch.float32
        with pytest.raises(ValueError, match="wgmma route"):
            fa.flash_attention_fwd(q.float(), q.float(), q.float(), with_lse=True)
    with pytest.raises(ValueError, match="wgmma route"):
        fa.flash_attention_fwd(*(torch.zeros((1, 2, 8, 64)),) * 3, with_lse=True)


def test_the_source_states_its_bound_and_names_no_backward_kernel_flash():
    src = CU.read_text()
    head = src[:src.index("#include")]
    assert "backward" in head and "replaces no TPU kernel" in head
    assert re.search(r"bounds\s+the\s+backward", head)
    bwd = src[src.index("namespace attn_bwd {"):src.index("}  // namespace attn_bwd")]
    names = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*(\w+)", bwd)
    assert sorted(names) == ["attn_bwd_dot_do_o", "attn_bwd_dq_convert", "attn_bwd_main"]
    assert not any(n.startswith("flash") for n in names)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

#: relative L2 of the kernel's dq, dk, dv against the plain vjp in f32 (from
#: the same bf16 inputs): the kernel rounds P and dS to bf16 before the
#: products that take them, its gradients to bf16 at the end, and sums dQ
#: over key blocks with atomics in no fixed order; the plain vjp in bf16
#: reads some 4e-3 (P, dP and its outputs rounded)
GRAD_REL_L2 = 1.5e-2
#: and an absolute floor a element, for gradients that are zero but for
#: rounding (one key: dS = P (dP - D) = 0, dq = dk = 0)
GRAD_ABS = 1e-3
#: the forward's log-sum-exp against the plain scores': f32 sums in another
#: order and exp2's approximation
LSE_TOL = dict(atol=2e-4, rtol=2e-5)


def _on_card(seed, B, H, K, Sq, Skv, hd, scale=1.0):
    q, k, v, g = _inputs(seed, B, H, K, Sq, Skv, hd, torch.float32)
    return [(t * s).to(torch.bfloat16).cuda() for t, s in zip((q, k, v, g), (scale, 1, 1, 1))]


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


CARD_CASES = [  # (B, G, K, Sq, Skv, hd, causal, window, softcap, q_offset)
    (2, 1, 4, 2048, 2048, 128, True, None, 0.0, 0),
    (1, 2, 2, 1, 1, 128, True, None, 0.0, 0),
    (2, 4, 2, 127, 127, 64, True, None, 0.0, 0),
    (2, 7, 2, 129, 129, 64, True, None, 0.0, 0),
    (1, 8, 1, 300, 300, 128, True, 64, 0.0, 0),
    (1, 2, 3, 129, 200, 128, True, None, 0.0, 71),
    (1, 4, 2, 333, 333, 128, False, None, 50.0, 0),
    (1, 1, 6, 1500, 1500, 64, False, None, 0.0, 0),
    (1, 1, 6, 448, 1500, 64, False, None, 0.0, 0),
    (1, 7, 2, 448, 448, 64, True, 100, 30.0, 0),
    (3, 1, 2, 257, 257, 128, False, 40, 0.0, 0),
    (5, 1, 4, 300, 300, 128, True, None, 0.0, 0),  # 20 kv heads: groups of 16 and 4
    (3, 2, 7, 200, 200, 64, True, None, 0.0, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,G,K,Sq,Skv,hd,causal,window,cap,off", CARD_CASES)
def test_the_kernel_backward_holds_the_plain_vjp(card, B, G, K, Sq, Skv, hd, causal, window,
                                                 cap, off):
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=off)
    q, k, v, g = _on_card(B * 1000 + Sq, B, G * K, K, Sq, Skv, hd, 4.0 if cap else 1.0)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    fn = fa.flash_attention_bwd
    before = fn.launches_by_variant.get("wgmma", 0)
    flash_attention(*xs, **kw).backward(g)
    torch.cuda.synchronize()
    assert fn.launches_by_variant.get("wgmma", 0) == before + 1
    want = _plain_grads(*(t.float() for t in (q, k, v, g)), **kw)
    bf16 = _plain_grads(q, k, v, g, **kw)
    for name, x, w, b in zip("qkv", xs, want, bf16, strict=True):
        got = x.grad
        assert got.dtype == torch.bfloat16 and not torch.isnan(got).any(), name
        err = float((got.float() - w).norm())
        limit = GRAD_REL_L2 * float(w.norm()) + GRAD_ABS * w.numel() ** 0.5
        assert err <= limit, (f"d{name}: relative L2 {_rel(got, w)}, L2 {err} > {limit} (the "
                              f"plain vjp in bf16: {_rel(b, w)})")


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Skv,causal,window,cap,off,hd", [
    (2048, 2048, True, None, 0.0, 0, 128), (129, 300, True, 50, 30.0, 171, 64),
    (448, 1500, False, None, 0.0, 0, 64), (1, 1, True, None, 0.0, 0, 128)])
def test_the_forward_lse_is_the_plain_scores_logsumexp(card, Sq, Skv, causal, window, cap,
                                                       off, hd):
    q, k, v, _ = _on_card(Sq + hd, 2, 4, 2, Sq, Skv, hd, 4.0 if cap else 1.0)
    with torch.no_grad():
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window, softcap=cap,
                                        q_offset=off, with_lse=True)
        plain = fa.flash_attention_fwd(q, k, v, causal=causal, window=window, softcap=cap,
                                       q_offset=off)
    torch.cuda.synchronize()
    assert torch.equal(o, plain)  # the instance with the log-sum-exp computes the same o
    kk = k.float().repeat_interleave(2, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * hd**-0.5
    if cap:
        s = torch.tanh(s / cap) * cap
    iq = torch.arange(Sq, device="cuda")[:, None] + off
    ik = torch.arange(Skv, device="cuda")[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device="cuda")
    if causal:
        ok &= ik <= iq
    if window is not None:
        ok &= (iq - ik) < window
    want = torch.where(ok, s, -torch.inf).logsumexp(-1)
    torch.testing.assert_close(lse[:, :, :Sq], want, **LSE_TOL)


@pytest.mark.cuda
def test_a_remat_full_layer_takes_the_kernel_backward(card, monkeypatch):
    """A reduced OLMo (bf16, hd 128, ``remat="full"``, flash): its gradients
    with the kernel backward against the same model's with the plain vjp
    (the same forward kernel), leaf by leaf in relative L2."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("olmo-1b").reduced().with_overrides(
        d_model=512, num_heads=4, num_kv_heads=2, head_dim=128, remat="full",
        attn_impl="flash")
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    t = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 257)).astype(np.int32)).cuda()
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    fn = fa.flash_attention_bwd
    before = fn.launches
    loss, grads = bundle.value_and_grad(params, batch)
    assert fn.launches == before + cfg.num_layers
    monkeypatch.setattr(ops, "kernel_backward", lambda q: False)
    loss_p, plain = bundle.value_and_grad(params, batch)
    assert fn.launches == before + cfg.num_layers
    assert float(loss) == float(loss_p)
    assert grads.keys() == plain.keys()
    for name in grads:
        rel = _rel(grads[name], plain[name])
        assert rel <= GRAD_REL_L2, f"{name}: relative L2 {rel}"
