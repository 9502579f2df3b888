"""The port's segment-scan wrappers against the JAX package's kernels
(the prefix scan, the router and the flat rank layout are in
tests/test_torch_kernels.py).

On the CPU every wrapper runs its kernel's plain torch version; the JAX
kernels run in Pallas interpret mode, as tests/test_kernel_conformance.py
runs them. Inputs are made with numpy from a seed and fed to both.

Ints, max/min and integer-valued f32 must match bit for bit. Random f32
sums match to rtol=1e-5: the association order of the scans differs.

chip_smoke.py holds the CUDA kernels against these plain versions on
the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.segment_reduce import segment_reduce as jax_segment_reduce  # noqa: E402
from repro.kernels.segment_reduce import segment_totals as jax_segment_totals  # noqa: E402
from repro_torch.core import shuffle as tsh  # noqa: E402
from repro_torch.kernels.segment_reduce import segment_reduce, segment_totals  # noqa: E402

OPS = ("sum", "max", "min")
_IDENT = {"sum": 0, "max": -(2**31 - 1), "min": 2**31 - 1}
_TFNS = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}


def bits_equal(got, ref):
    g, r = np.asarray(got), np.asarray(ref)
    return g.dtype == r.dtype and g.shape == r.shape and np.array_equal(g, r)


def _data(n, dtype, seed=0):
    """Integer-valued samples: every op is associative-exact."""
    r = np.random.default_rng(seed).integers(-1000, 1000, n)
    if dtype == "bool":
        return r % 2 == 0
    return r.astype(dtype)


def _segments(n, n_keys, valid_frac, dtype, d=None, seed=3):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, n_keys, n).astype(np.int32))
    valid = rng.random(n) < valid_frac
    vals = rng.integers(-50, 50, n if d is None else (n, d)).astype(dtype)
    return keys, valid, vals


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.array(a)) for a in arrays]


# ---------------------------------------------------------------------------
# segment_reduce / segment_totals
# ---------------------------------------------------------------------------

_SEG_CASES = [
    (256, 17, 0.8, None),     # ragged runs, scattered invalids
    (300, 17, 0.8, 4),        # non-multiple of block, row values
    (200, 1, 1.0, None),      # single segment spanning blocks
    (64, 40, 0.0, None),      # all-invalid: every row its own boundary
    (1, 1, 1.0, None),        # single row
]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("n,n_keys,valid_frac,d", _SEG_CASES)
def test_segment_reduce_matches_jax(op, dtype, n, n_keys, valid_frac, d):
    (jk, jv, jx), (tk, tv, tx) = _both(*_segments(n, n_keys, valid_frac, dtype, d))
    h1, s1 = jax_segment_reduce(jk, jv, jx, op=op, block=64, interpret=True)
    h2, s2 = segment_reduce(tk, tv, tx, op=op, block=64)
    assert bits_equal(h2, h1) and bits_equal(s2, s1)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("n,n_keys,valid_frac,d", _SEG_CASES)
def test_segment_totals_matches_jax(op, dtype, n, n_keys, valid_frac, d):
    (jk, jv, jx), (tk, tv, tx) = _both(*_segments(n, n_keys, valid_frac, dtype, d))
    h1, t1 = jax_segment_totals(jk, jv, jx, op, jnp.asarray(_IDENT[op], dtype),
                                block=64, interpret=True)
    h2, t2 = segment_totals(tk, tv, tx, op, torch.tensor(_IDENT[op]).to(tx.dtype),
                            block=64)
    assert bits_equal(h2, h1) and bits_equal(t2, t1)


@pytest.mark.parametrize("op", ["max", "min"])
def test_segment_totals_bool_values(op):
    keys, valid, _ = _segments(128, 9, 0.9, "int32")
    vals = _data(128, "bool", seed=5)
    (jk, jv, jx), (tk, tv, tx) = _both(keys, valid, vals)
    h1, t1 = jax_segment_totals(jk, jv, jx, op, jnp.asarray(op == "min"),
                                block=32, interpret=True)
    h2, t2 = segment_totals(tk, tv, tx, op, torch.tensor(op == "min"), block=32)
    assert bits_equal(h2, h1) and bits_equal(t2, t1)


def test_segment_totals_nonzero_identity_at_invalid_rows():
    (jk, jv, jx), (tk, tv, tx) = _both(*_segments(96, 7, 0.5, "int32", seed=9))
    _, t1 = jax_segment_totals(jk, jv, jx, "sum", jnp.int32(41), block=32,
                               interpret=True)
    _, t2 = segment_totals(tk, tv, tx, "sum", torch.tensor(41, dtype=torch.int32),
                           block=32)
    assert bits_equal(t2, t1)
    assert bool((t2[~tv] == 41).all())


def test_segment_totals_empty_input():
    z = torch.zeros(0, dtype=torch.int32)
    h, t = segment_totals(z, torch.zeros(0, dtype=torch.bool), z, "sum", 0)
    assert h.shape == (0,) and t.shape == (0,)


def test_segment_reduce_random_f32_sum_within_tolerance():
    keys, valid, _ = _segments(500, 30, 0.9, "int32")
    vals = np.random.default_rng(4).random((500, 4)).astype(np.float32)
    (jk, jv, jx), (tk, tv, tx) = _both(keys, valid, vals)
    _, s1 = jax_segment_reduce(jk, jv, jx, op="sum", block=64, interpret=True)
    _, s2 = segment_reduce(tk, tv, tx, op="sum", block=64)
    np.testing.assert_allclose(np.asarray(s2), np.asarray(s1), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("op", OPS)
def test_segment_totals_matches_the_shuffle_plain_path(op):
    # segment_totals is the kernel-tier drop-in for core/shuffle's plain
    # segmented_reduce (which the slice tests hold against the reference's)
    keys, valid, vals = _segments(256, 17, 0.8, "int32")
    _, (tk, tv, tx) = _both(keys, valid, vals)
    h2, t2 = tsh.segmented_reduce(tk, tv, tx, _TFNS[op], _IDENT[op])
    h3, t3 = segment_totals(tk, tv, tx, op, _IDENT[op], block=64)
    assert bits_equal(h3, h2) and bits_equal(t3, t2)


