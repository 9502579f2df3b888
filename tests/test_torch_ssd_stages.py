"""The SSD kernel's four-step dataflow (``ssd_stages_ref``: C·Bᵀ, the
chunks' own states, the pass across chunks, the chunk scan) against the JAX
package's SSD scan and its oracle, on the same inputs (numpy, from a seed).

The CUDA kernel cannot run on the CPU; this mirror of its dataflow, in
plain torch, is what the CPU can hold against the reference. The kernel
itself is held against ``ssd_chunked`` on the card by ``chip_smoke.py``.

Tolerances. In f32, atol 2e-4 and rtol 1e-3, the JAX kernel test's own
(``SSD_TOL`` in ``chip_smoke.py``): the decays and the chunk products are
summed in other orders. In bf16 the mirror, like the kernel, computes in
f32 on the bf16 values and rounds y once: held to the f32 oracle on the
same values at atol 1e-3, rtol 5e-3 (half a bf16 ulp is 2^-9 relative),
and to the JAX kernel's bf16 output at 3e-2 of its scale (each side rounds
once, so a value near a tie lands an ulp apart), as ``test_torch_ssm.py``
holds the bf16 SSD.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ssd_ref as j_ssd_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_stages_ref  # noqa: E402

SSD_TOL = {"float32": (2e-4, 1e-3), "bfloat16": (1e-3, 5e-3)}
BF16_SCALE_TOL = 3e-2


def _inputs(seed, B, S, H, P, G, N):
    """x ~ N(0, 1), dt = softplus(N(0, 1)), A_log ~ N(0, 0.5), B/C ~ N(0, 0.3):
    the JAX kernel test's distributions."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A_log = (rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    return x, dt, A_log, Bm, Cm


def _as(a, dtype):
    """x, B, C in ``dtype`` (dt and A_log stay f32, as the kernel takes them)."""
    x, dt, A_log, Bm, Cm = a
    if dtype == "bfloat16":
        x, Bm, Cm = (np.array(jnp.asarray(t, jnp.bfloat16).astype(jnp.float32))
                     for t in (x, Bm, Cm))
    return x, dt, A_log, Bm, Cm


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


CHUNKS = [1, 3, 8]  # nc: no state passed, passed across 2 and 7 boundaries
SHAPE = dict(B=2, H=4, P=16, N=16, q=16)


@pytest.mark.parametrize("nc", CHUNKS)
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_stages_match_the_jax_kernel_and_oracle(nc, G, dtype):
    B, H, P, N, q = (SHAPE[k] for k in ("B", "H", "P", "N", "q"))
    S = nc * q
    a = _as(_inputs(100 * nc + G, B, S, H, P, G, N), dtype)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    x, dt, A_log, Bm, Cm = (torch.from_numpy(t) for t in a)
    y, st = ssd_stages_ref(x.to(tdt), dt, A_log, Bm.to(tdt), Cm.to(tdt), q)
    assert y.dtype == tdt and tuple(y.shape) == (B, S, H, P)
    assert st.dtype == torch.float32 and tuple(st.shape) == (B, H, P, N)

    ja = list(map(jnp.asarray, a))  # the same values, in f32
    yo, so = j_ssd_ref(*ja, q)
    atol, rtol = SSD_TOL[dtype]
    np.testing.assert_allclose(_np(y), _np(yo), atol=atol, rtol=rtol)
    np.testing.assert_allclose(_np(st), _np(so), atol=2e-4, rtol=1e-3)

    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    yk, sk = j_ssd_scan(ja[0].astype(jdt), ja[1], ja[2], ja[3].astype(jdt),
                        ja[4].astype(jdt), q, True)
    if dtype == "float32":
        np.testing.assert_allclose(_np(y), _np(yk), atol=atol, rtol=rtol)
    else:
        scale = max(float(np.abs(_np(yk)).max()), 1.0)
        np.testing.assert_allclose(_np(y), _np(yk), atol=BF16_SCALE_TOL * scale,
                                   rtol=BF16_SCALE_TOL)
    np.testing.assert_allclose(_np(st), _np(sk), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("B,S,H,P,G,N,q", [
    (1, 2048, 4, 64, 1, 128, 256),  # the Mamba2-780M prefill's widths, 8 chunks
    (2, 768, 4, 64, 2, 128, 256),
    (2, 75, 4, 16, 2, 16, 16),      # ragged S: the tail padded with dt = 0
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hi_lo_split_stays_within_the_ssd_tolerance(B, S, H, P, G, N, q, dtype):
    """The kernel's tensor-core products see every f32 operand as a bf16
    hi/lo pair and take hi·hi + hi·lo + lo·hi; emulated here in f32, the
    result stays within the tolerance the kernel is held to on the card."""
    a = _as(_inputs(7 * S + P + G, B, S, H, P, G, N), dtype)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    x, dt, A_log, Bm, Cm = (torch.from_numpy(t) for t in a)
    y, st = ssd_stages_ref(x.to(tdt), dt, A_log, Bm.to(tdt), Cm.to(tdt), q, split=True)
    yo, so = j_ssd_ref(*map(jnp.asarray, a), q)
    atol, rtol = SSD_TOL[dtype]
    np.testing.assert_allclose(_np(y), _np(yo), atol=atol, rtol=rtol)
    np.testing.assert_allclose(_np(st), _np(so), atol=2e-4, rtol=1e-3)


def test_the_split_is_exact_on_bf16_values_and_keeps_16_bits_of_f32():
    """A bf16 value splits into itself and a zero lo part (x, B and C in
    bf16 enter the products exactly); an f32 value keeps about 16 bits."""
    from repro_torch.kernels.ssd_scan.ref import _split

    v = torch.from_numpy(np.random.default_rng(3).standard_normal(4096).astype(np.float32))
    hi, lo = _split(v.bfloat16().float())
    assert torch.equal(hi, v.bfloat16().float()) and not lo.any()
    hi, lo = _split(v)
    rel = ((hi + lo - v).abs() / v.abs()).max()
    assert float(rel) <= 2.0**-16
