"""The port's flash attention against the JAX package's.

On the CPU the port's ``flash_attention`` takes its plain version; the JAX
``flash_attention`` runs its Pallas kernel in interpret mode, as
tests/test_kernels.py runs it (blocks of 16 keep it quick). Inputs are made
with numpy from a seed. f32 is held to atol 2e-5 / rtol 1e-4: the two differ
only in summation order and in the online softmax's rescaling. The CUDA
kernel itself is held against the plain version on the card by
``tests/test_torch_card_kernels.py`` and ``chip_smoke.py``.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import attention_ref as j_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref, flash_attention  # noqa: E402

fa = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")

ATOL, RTOL = 2e-5, 1e-4
#: bf16: both round P to bf16 before P·V and the output to bf16, but may
#: round a value on either side of a tie differently (one bf16 ulp, 2^-8)
BF16_TOL = 2e-2


def _inputs(seed, B, H, K, Sq, Skv, hd, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, hd)).astype(dtype)
    k = rng.standard_normal((B, K, Skv, hd)).astype(dtype)
    v = rng.standard_normal((B, K, Skv, hd)).astype(dtype)
    return q, k, v


MASKS = [  # (Sq, Skv, causal, window, softcap); q_offset = Skv - Sq when causal
    (5, 130, True, None, 0.0),
    (130, 130, True, 16, 0.0),
    (1, 130, True, None, 50.0),
    (130, 5, False, None, 0.0),
    (130, 130, False, 16, 50.0),
]


@pytest.mark.parametrize("G", [1, 2, 5])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("Sq,Skv,causal,window,cap", MASKS)
def test_flash_matches_the_jax_kernel(G, hd, Sq, Skv, causal, window, cap):
    K = 2
    q, k, v = _inputs(G * 100 + hd + Sq, 2, K * G, K, Sq, Skv, hd)
    if cap:
        q = q * 8  # scores reach the tanh's bend
    off = Skv - Sq if causal else 0
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, window, cap,
                   off, 16, 16, True)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal, window, cap, off, 16, 16)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,cap,off", [
    (True, None, 0.0, 0), (True, 8, 30.0, 3), (False, None, 0.0, 0)])
def test_attention_ref_matches_the_jax_oracle(dtype, causal, window, cap, off):
    q, k, v = _inputs(7, 1, 6, 2, 9, 12, 16)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = j_ref(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd), causal=causal,
                 window=window, softcap=cap, q_offset=off)
    td = getattr(torch, dtype)
    got = attention_ref(torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
                        torch.from_numpy(v).to(td), causal=causal, window=window,
                        softcap=cap, q_offset=off)
    assert got.dtype == td
    tol = BF16_TOL if dtype == "bfloat16" else ATOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_kv_len_masks_trailing_columns_on_the_plain_path():
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 1, 4, 2, 6, 20, 16))
    got = fa.flash_attention_fwd(q, k, v, causal=False, kv_len=11)
    want = attention_ref(q, k[:, :, :11], v[:, :, :11], causal=False)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_cpu_calls_take_the_plain_version_and_count_no_launch():
    kernels.reset_launches()
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, 1, 4, 2, 8, 8, 64))
    out = flash_attention(q, k, v)
    torch.testing.assert_close(out, attention_ref(q, k, v), atol=0, rtol=0)
    fn = kernels.launch_counters()["flash_attention"]
    assert fn is fa.flash_attention_fwd
    assert fn.launches == 0 and fn.tune_launches == 0 and not fn.geometries


def test_cuda_library_name_follows_its_source(tmp_path, monkeypatch):
    """An edited kernel source builds to a new library (the build is keyed
    by a hash of the sources and flags), under build/kernels/cuda."""
    path = _cuda.library_path("flash_attention")
    assert path.parent == kernels.BUILD_DIR / "cuda"
    assert path.name.startswith("flash_attention-") and path.suffix == ".so"
    src = (_cuda.CSRC / "flash_attention.cu").read_text()
    assert "Replaces the Pallas TPU kernel src/repro/kernels/" in src
    (tmp_path / "flash_attention.cu").write_text(src + "\n// edited\n")
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    assert _cuda.library_path("flash_attention") != path
    assert "-gencode" in _cuda.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in _cuda.NVCC_FLAGS


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "fma"),  # its O accumulator would not fit beside S and P
    (torch.float32, 64, "fma"), (torch.float32, 128, "fma"), (torch.float32, 256, "fma"),
])
def test_the_wrapper_routes_by_dtype_and_head_dim(dtype, hd, route):
    """The route a CUDA call takes is decided before the launch from its
    dtype and head dim (the wrapper passes it to the C entry point, which
    only dispatches): bf16 at hd 64 and 128 on the tensor cores,
    f32 at every hd and bf16 at hd 256 on the FMA kernel."""
    assert fa.variant(dtype, hd) == route
    assert set(fa.WGMMA_HEAD_DIMS) <= set(fa.HEAD_DIMS)


def test_cpu_calls_of_either_route_count_no_launch():
    """A bf16 call at hd 128 (the serve path's, wgmma on the card) and an
    f32 one (fma on the card) both take the plain version on the CPU and
    count no launch under any route."""
    kernels.reset_launches()
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.from_numpy(a).to(dtype) for a in _inputs(5, 1, 4, 2, 8, 8, 128))
        out = fa.flash_attention_fwd(q, k, v)
        torch.testing.assert_close(out, attention_ref(q, k, v), atol=0, rtol=0)
    fn = fa.flash_attention_fwd
    assert fn.launches == 0 and fn.launches_by_variant == {} and not fn.geometries


def test_a_shared_header_rekeys_every_cuda_library(tmp_path, monkeypatch):
    """The CUDA sources include ``csrc/sm90.cuh``; an edit of that header
    builds every library anew (each library's name hashes its source, every
    shared header and the flags)."""
    srcs = sorted(_cuda.CSRC.glob("*.cu*"))
    assert _cuda.CSRC / "sm90.cuh" in srcs
    for name in ("flash_attention", "ssd_scan", "decode_attention"):
        assert '#include "sm90.cuh"' in (_cuda.CSRC / f"{name}.cu").read_text()
    for src in srcs:
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    names = [src.stem for src in srcs if src.suffix == ".cu"]
    assert {"flash_attention", "ssd_scan", "moe_route", "decode_attention"} <= set(names)
    before = {n: _cuda.library_path(n) for n in names}
    header = tmp_path / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _cuda.library_path(n) for n in names}
    assert all(before[n] != after[n] and after[n].name.startswith(f"{n}-") for n in names)
