"""The four configs of the families already served (``olmo-1b``, ``yi-9b``,
``gemma3-4b``, ``phi3.5-moe-42b-a6.6b``) against the JAX package's: each
equal field for field, source included, and each ``reduced()`` copy's
prefill logits against the JAX package's on the same weights (carried
across by ``interop.params_from_reference``) and the same tokens.

What each exercises: olmo the non-parametric LayerNorm and tied
embeddings; yi GQA at 8 query heads a KV head (reduced: 2); gemma3 the
logit softcap, the 5:1 local/global windows (which keep the plain
attention path in both packages) and tied embeddings; phi3.5-MoE its 16
experts, top-2 (``reduced()`` sets 4 experts; the test restores 16).
Tolerance: f32 logits at 1e-4 of their scale, as tests/test_torch_models.py
holds the dense family (summation order and the two libraries' exp/cos/sin
differ in the last bits)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from _torch_families import jax_fields  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.interop import params_from_reference  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402

NAMES = ["gemma3-4b", "olmo-1b", "phi3.5-moe-42b-a6.6b", "yi-9b"]
TOL = 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("name", NAMES)
def test_config_equals_the_reference_field_for_field(name):
    j, t = dataclasses.asdict(j_config(name)), jax_fields(dataclasses.asdict(t_config(name)))
    assert t == j
    assert jax_fields(dataclasses.asdict(t_config(name).reduced())) == dataclasses.asdict(
        j_config(name).reduced())


def _reduced(get, name):
    cfg = get(name)
    small = cfg.reduced().with_overrides(param_dtype="float32")
    if cfg.is_moe:
        small = small.with_overrides(num_experts=cfg.num_experts,
                                     experts_per_token=cfg.experts_per_token)
    return small


@pytest.mark.parametrize("name", NAMES)
def test_reduced_prefill_logits_match_the_reference(name):
    jc, tc = _reduced(j_config, name), _reduced(t_config, name)
    assert dataclasses.asdict(jc) == jax_fields(dataclasses.asdict(tc))
    jb, tb = j_build(jc), t_build(tc)
    jp = jb.init(jax.random.PRNGKey(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tc)
    toks = np.random.default_rng(5).integers(0, tc.vocab_size, (2, 40)).astype(np.int32)
    jl, _ = jb.prefill(jp, tokens=jnp.asarray(toks), cache_len=48)
    tl, cache = tb.prefill(tp, tokens=torch.from_numpy(toks), cache_len=48)
    want = _np(jl)
    assert np.isfinite(want).all() and tl.shape == jl.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(_np(tl), want, atol=TOL * scale, rtol=TOL)
    assert cache["pos"].tolist() == [40, 40]
