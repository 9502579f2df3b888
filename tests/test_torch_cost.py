"""The port's static pricing against the JAX package's, on the CPU.

``repro_torch.launch.hlo_cost.analyze`` and ``CostModel.price_hlo`` must
equal the reference's exactly on the same compiled HLO text (the texts of
tests/test_hlo_cost.py, made here with ``jax.jit(f).lower(...).compile()``,
and an 8-way ``psum`` lowered on 8 fake devices in the subprocess
tests/_torch_profile_main.py).

``price_fn`` must equal the reference's ``price_fn`` — flops, HBM bytes and
dispatches — on a table of functions written once in ``jnp`` and once in
torch. Where the two graphs differ by construction the table states the
difference and the test holds it exactly (tolerance 0):

* a Python scalar in a torch op is not a tensor, while a jaxpr literal is a
  0-d array of its dtype: the reference counts 4 more bytes (f32) per
  literal operand;
* ``reshape`` of a transposed view materialises it in torch
  (``clone`` + ``_unsafe_view``): one dispatch more, and its read and write;
* ``lax.cond`` converts its bool predicate to int32 first (one more
  dispatch; 1 + 4 bytes), and the reference's ``cond`` then reads a 4-byte
  predicate where torch's reads 1.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.launch import hlo_cost as jhlo  # noqa: E402
from repro.profile.cost import CostEstimate as JEstimate  # noqa: E402
from repro.profile.cost import CostModel as JModel  # noqa: E402
from repro.profile.cost import DeviceParams as JParams  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.launch import hlo_cost as thlo  # noqa: E402
from repro_torch.profile import CostEstimate, CostModel, DeviceParams  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
S = jax.ShapeDtypeStruct


def _hlo(f, *avals):
    return jax.jit(f).lower(*avals).compile().as_text()


def _scan(x):
    return jax.lax.scan(lambda c, _: (c @ c, None), x, None, length=10)[0]


HLO_CASES = {
    "scan": (_scan, [S((128, 128), jnp.float32)]),
    "dot": (lambda a, b: a @ b, [S((64, 32), jnp.float32), S((32, 16), jnp.float32)]),
    "dus": (lambda x, u: jax.lax.dynamic_update_slice(x, u, (0, 0)),
            [S((1024, 1024), jnp.float32), S((4, 4), jnp.float32)]),
    "bf16_add": (lambda v: v + v, [S((32, 32), jnp.bfloat16)]),
    "tanh_dot": (lambda x, y: jnp.tanh(x @ y) + 1.0,
                 [S((128, 256), jnp.float32), S((256, 64), jnp.float32)]),
    "chain": (lambda x: (x * 2 + 1) * (x - 3), [S((1024,), jnp.float32)]),
}


@pytest.fixture(scope="module")
def jax_p8(tmp_path_factory):
    out = tmp_path_factory.mktemp("cost") / "jax_p8.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, os.path.join(HERE, "_torch_profile_main.py"),
                        str(out)], env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "TORCH_PROFILE_JAX_OK" in r.stdout, r.stderr[-3000:]
    return json.loads(out.read_text())


def _same_pricing(text):
    assert thlo.analyze(text) == jhlo.analyze(text)
    assert thlo.top_collectives(text) == jhlo.top_collectives(text)
    for collective in (True, False):
        got = CostModel().price_hlo(text, collective)
        want = JModel().price_hlo(text, collective)
        assert (got.flops, got.hbm_bytes, got.wire_bytes, got.dispatches) == (
            want.flops, want.hbm_bytes, want.wire_bytes, want.dispatches)


@pytest.mark.parametrize("name", sorted(HLO_CASES))
def test_hlo_analysis_and_price_equal_the_reference(name):
    f, avals = HLO_CASES[name]
    _same_pricing(_hlo(f, *avals))


def test_psum_hlo_at_p8_prices_wire_bytes_as_the_reference(jax_p8):
    text = jax_p8["psum_hlo"]
    r = thlo.analyze(text)
    assert r["comm_bytes_total_per_device"] > 0 and r["wire_bytes_per_device"] > 0
    _same_pricing(text)


@pytest.mark.parametrize("s", ["f32[16,4]{1,0}", "(bf16[8], s32[2])", "pred[3,3]",
                               "f8e4m3[64]", "f8e5m2fnuz[64]", "u2[8]", "s4[7]",
                               "f8e8m0fnu[3,5]", "(f32[], u4[9])"])
def test_shape_parsing_equals_the_reference(s):
    assert thlo.shape_bytes(s) == jhlo.shape_bytes(s)
    assert thlo.shape_elems(s) == jhlo.shape_elems(s)


# ---------------------------------------------------------------------------
# price_fn: the same functions in jnp and in torch
# ---------------------------------------------------------------------------

def _resh_j(x):
    return x.reshape(32, 64).T.reshape(-1)


def _resh_t(x):
    return x.reshape(32, 64).t().reshape(-1)


#: name -> (jnp function, torch function, [(shape, dtype name)], difference
#: of the reference's estimate over the port's: (flops, bytes, dispatches))
FN_TABLE = {
    "narrow_chain": (lambda x: (x * 2 + 1) * (x - 3), lambda x: (x * 2 + 1) * (x - 3),
                     [((1024,), "float32")], (0, 3 * 4, 0)),
    "tanh_matmul": (lambda a, b: jnp.tanh(a @ b) + 1, lambda a, b: torch.tanh(a @ b) + 1,
                    [((128, 256), "float32"), ((256, 64), "float32")], (0, 4, 0)),
    "bf16_add": (lambda v: v + v, lambda v: v + v, [((32, 32), "bfloat16")], (0, 0, 0)),
    "batched_matmul": (lambda a, b: a @ b, torch.bmm,
                       [((4, 8, 16), "float32"), ((4, 16, 32), "float32")], (0, 0, 0)),
    "reshape_transpose": (_resh_j, _resh_t, [((2048,), "float32")], (0, -2 * 2048 * 4, -1)),
    "cond": (lambda p, x: jax.lax.cond(p, jnp.sin, jnp.cos, x),
             lambda p, x: torch.cond(p, torch.sin, torch.cos, (x,)),
             [((), "bool"), ((8,), "float32")], (0, 1 + 4 + 3, 1)),
}


def _inputs(spec):
    j = [S(shape, getattr(jnp, dt)) for shape, dt in spec]
    t = [torch.zeros(shape, dtype=getattr(torch, dt)) for shape, dt in spec]
    return j, t


@pytest.mark.parametrize("name", sorted(FN_TABLE))
def test_price_fn_equals_the_reference(name):
    jf, tf, spec, (d_flops, d_bytes, d_disp) = FN_TABLE[name]
    ja, ta = _inputs(spec)
    want = JModel().price_fn(jf, *ja)
    got = CostModel().price_fn(tf, *ta)
    assert got.flops == want.flops - d_flops
    assert got.hbm_bytes == want.hbm_bytes - d_bytes
    assert got.dispatches == want.dispatches - d_disp
    assert got.wire_bytes == want.wire_bytes == 0.0


def test_narrow_chain_prices_exactly_and_scales_with_blocks():
    m, jm = CostModel(), JModel()
    x = torch.zeros(1024)
    chain = lambda v: (v * 2 + 1) * (v - 3)  # noqa: E731
    one, four = m.price_fn(chain, x), m.price_fn(chain, x, nblocks=4)
    assert one.flops == 4 * 1024  # mul, add, sub, mul on 1024 elements
    assert (four.flops, four.hbm_bytes, four.dispatches) == (
        4 * one.flops, 4 * one.hbm_bytes, 4 * one.dispatches)
    jone = jm.price_jaxpr(jax.make_jaxpr(chain)(S((1024,), jnp.float32)), nblocks=4)
    assert jone.flops == four.flops and jone.dispatches == four.dispatches
    assert m.stats["jaxprs_priced"] == 2 and jm.stats["jaxprs_priced"] == 1


def test_matmul_prices_two_n_cubed():
    n = 96
    est = CostModel().price_fn(torch.mm, torch.zeros(n, n), torch.zeros(n, n))
    assert est.flops == 2 * n**3 and est.dispatches == 1
    assert est.hbm_bytes == 3 * n * n * 4


def test_meta_and_fake_inputs_price_like_real_ones():
    f = lambda a, b: torch.tanh(a @ b) + 1  # noqa: E731
    real = CostModel().price_fn(f, torch.zeros(8, 16), torch.zeros(16, 4))
    meta = CostModel().price_fn(f, torch.empty(8, 16, device="meta"),
                                torch.empty(16, 4, device="meta"))
    with FakeTensorMode():
        fa, fb = torch.empty(8, 16), torch.empty(16, 4)
    fake = CostModel().price_fn(f, fa, fb)
    assert real == meta == fake


# ---------------------------------------------------------------------------
# the port's kernel calls
# ---------------------------------------------------------------------------


def _fake_cuda(*specs):
    with FakeTensorMode():
        return [torch.empty(shape, dtype=dt, device="cuda") for shape, dt in specs]


def test_a_kernel_call_on_fake_cuda_tensors_prices_as_one_call_and_launches_nothing():
    """A flash call on fake CUDA tensors is one dispatch: q, k, v read and o
    written once, 4·hd·B·H FLOP per live (row, key) pair; the counters stay
    at 0. The same call on CPU tensors prices the same (a fake tensor runs
    neither the kernel nor the plain version)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.flash_attention import live_pairs

    kernels.reset_launches()
    bf = torch.bfloat16
    q, k, v = _fake_cuda(((1, 4, 128, 64), bf), ((1, 2, 128, 64), bf), ((1, 2, 128, 64), bf))
    est = CostModel().price_fn(lambda q, k, v: flash_attention(q, k, v), q, k, v)
    assert live_pairs(128, 128, True, None, 0) == 128 * 129 // 2
    assert est == CostEstimate(4 * 64 * 4 * (128 * 129 // 2), (2 * 32768 + 2 * 16384) * 2,
                               0.0, 1.0)
    assert live_pairs(6, 10, True, 3, 4) == 3 * 6
    assert all(fn.launches == fn.tune_launches == 0
               for fn in kernels.launch_counters().values())
    cpu = CostModel().price_fn(lambda q, k, v: flash_attention(q, k, v),
                               *(torch.zeros(t.shape, dtype=bf) for t in (q, k, v)))
    assert cpu == est


def test_every_kernel_wrapper_prices_on_fake_cuda_tensors():
    from repro_torch.kernels.moe_route import bucket_route, moe_route
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_reduce_fwd
    from repro_torch.kernels.ssd_scan import prefix_scan
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_fwd, work_flops

    kernels.reset_launches()
    f32, i32 = torch.float32, torch.int32
    (logits,) = _fake_cuda(((256, 16), f32))
    est = CostModel().price_fn(lambda x: moe_route(x, 2, 40)[0], logits)
    assert est == CostEstimate(256 * 16, 256 * 16 * 4 + 256 * 2 * (4 + 4 + 4 + 1), 0, 1)
    (dest,) = _fake_cuda(((1000,), i32))
    est = CostModel().price_fn(lambda d: bucket_route(d, 16, 80)[2], dest)
    assert est == CostEstimate(1000, 1000 * 4 + 1000 * (4 + 1) + 16 * 4, 0, 1)
    vals, bnd = _fake_cuda(((512, 2), i32), ((512,), torch.bool))
    est = CostModel().price_fn(lambda a, b: segment_reduce_fwd(a, b, "max"), vals, bnd)
    assert est == CostEstimate(1024, 512 * 2 * 4 * 2 + 512, 0, 1)
    (x,) = _fake_cuda(((4096,), f32))
    est = CostModel().price_fn(lambda t: prefix_scan(t, op="min", reverse=True), x)
    assert est.flops == 4096 and est.dispatches == 1
    xs, dt, a, bm = _fake_cuda(((1, 64, 4, 16), f32), ((1, 64, 4), f32), ((4,), f32),
                               ((1, 64, 1, 8), f32))
    # (the dispatcher itself: a CPU-only torch cannot trace ops.ssd_scan's
    # slice of a fake CUDA tensor)
    est = CostModel().price_fn(lambda *t: ssd_scan_fwd(*t, 32)[0], xs, dt, a, bm, bm)
    assert est.flops == work_flops((1, 64, 4, 16), (1, 64, 1, 8), 32)
    assert est.dispatches == 1
    assert all(fn.launches == fn.tune_launches == 0
               for fn in kernels.launch_counters().values())


def _refused_calls():
    """(name, fn, operand specs, error): a call each wrapper's launch would
    refuse on the card, by shape, dtype or limit alone."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_route import bucket_route, moe_route
    from repro_torch.kernels.moe_route.route import MAX_BUCKETS
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_reduce_fwd
    from repro_torch.kernels.ssd_scan.prefix import prefix_scan_fwd
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_fwd

    f32, bf = torch.float32, torch.bfloat16
    return {
        "flash head_dim 96": (lambda q, k, v: flash_attention(q, k, v),
                              [((1, 4, 64, 96), bf), ((1, 2, 64, 96), bf),
                               ((1, 2, 64, 96), bf)]),
        "moe_route 129 experts": (lambda x: moe_route(x, 2, 40)[0], [((32, 129), f32)]),
        "moe_route k 17": (lambda x: moe_route(x, 17, 40)[0], [((32, 72), f32)]),
        "bucket_route past MAX_BUCKETS": (lambda d: bucket_route(d, MAX_BUCKETS + 1, 8)[2],
                                          [((100,), torch.int32)]),
        "segment_reduce float64": (lambda a, b: segment_reduce_fwd(a, b, "sum"),
                                   [((64, 2), torch.float64), ((64,), torch.bool)]),
        "prefix_scan float64": (lambda t: prefix_scan_fwd(t, "sum"), [((64,), torch.float64)]),
        "ssd_scan chunk 512": (lambda *t: ssd_scan_fwd(*t, 512)[0],
                               [((1, 512, 4, 16), f32), ((1, 512, 4), f32), ((4,), f32),
                                ((1, 512, 1, 8), f32), ((1, 512, 1, 8), f32)]),
    }


@pytest.mark.parametrize("name", sorted(_refused_calls()))
def test_a_call_the_card_refuses_is_refused_when_priced(name):
    """On fake CUDA tensors a wrapper runs its launch's checks before it
    prices, so nothing prices that the card would not run; on fake CPU
    tensors the call prices, as the plain version has no such limit."""
    fn, specs = _refused_calls()[name]
    with pytest.raises(ValueError):
        CostModel().price_fn(fn, *_fake_cuda(*specs))
    with FakeTensorMode():
        cpu = [torch.empty(shape, dtype=dt) for shape, dt in specs]
    assert CostModel().price_fn(fn, *cpu).dispatches == 1


# ---------------------------------------------------------------------------
# the rest of the interface
# ---------------------------------------------------------------------------


def test_device_params_estimates_and_predictions_equal_the_reference():
    assert vars(DeviceParams()) == vars(JParams())
    a, b = CostEstimate(1e6, 1e5, 3.0, 2.0), CostEstimate(2.0, 4.0, 8.0, 1.0)
    ja, jb = JEstimate(1e6, 1e5, 3.0, 2.0), JEstimate(2.0, 4.0, 8.0, 1.0)
    assert vars(a + b) == vars(ja + jb) and vars(a.scaled(2.5)) == vars(ja.scaled(2.5))
    m, jm = CostModel(), JModel()
    for est, jest in ((a, ja), (b, jb), (CostEstimate(flops=1e9), JEstimate(flops=1e9))):
        assert m.predict_s(est) == jm.predict_s(jest)
    pairs = [(1.0, 2.0), (1.0, 2.5), (2.0, 1.0), (0.0, 3.0)]
    assert m.fit(pairs) == jm.fit(pairs)
    assert m.predict_s(a) == jm.predict_s(ja)
    fast, jfast = m.with_params(flops_per_s=1e12), jm.with_params(flops_per_s=1e12)
    assert fast.predict_s(a) == jfast.predict_s(ja) < m.predict_s(a)
    assert fast.params.dispatch_s == m.params.dispatch_s
    assert m.snapshot().keys() == jm.snapshot().keys()
    assert m.snapshot()["scale"] == jm.snapshot()["scale"]


def test_predict_seconds_monotone_in_work():
    m = CostModel(DeviceParams())
    small = CostEstimate(flops=1e6, hbm_bytes=1e5, dispatches=1)
    big = CostEstimate(flops=1e9, hbm_bytes=1e8, dispatches=1)
    assert m.predict_s(big) > m.predict_s(small) > 0


def test_fit_rescales_toward_observed():
    m = CostModel()
    est = CostEstimate(flops=1e9)
    before = m.predict_s(est)
    m.fit([(before, 2 * before)] * 3)
    assert abs(m.predict_s(est) - 2 * before) / (2 * before) < 1e-6


def test_the_cpu_shuffle_path_prices_through_the_router():
    """The bucket router's plain version has a data-dependent shape
    (``bincount``), which fake mode cannot trace; the wrapper prices the
    call as one kernel call on a fake CPU tensor as on a CUDA one."""
    from repro_torch.kernels.moe_route import bucket_route

    est = CostModel().price_fn(lambda d: bucket_route(d, 8, 40)[0] + 1,
                               torch.zeros(300, dtype=torch.int32))
    assert est == CostEstimate(300 + 300, 300 * 4 + 300 * 5 + 8 * 4 + 2 * 300 * 4, 0, 2)
