"""Helpers shared by tests/test_torch_{hybrid,vlm,encdec}.py: the reduced
config of one architecture in both packages, its weights carried across, and
the comparisons.

Weights: the port's initialisation from a seed (a few ms, where compiling the
JAX ``init`` takes seconds), carried to the JAX package by
``interop.params_to_reference`` and back into a port model by
``params_from_reference``, so both packages run the same values. The
configs are f32 (``param_dtype="float32"``) unless a test says otherwise,
so the tolerances can be tight.
"""
import dataclasses
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as j_config
from repro.configs.base import ArchConfig as JArchConfig
from repro.models import build_model as j_build
from repro_torch.configs import get_config as t_config
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.interop import params_from_reference, params_to_reference, reference_tree
from repro_torch.models import build_model as t_build

#: f32 elementwise tolerance of activations, logits and caches (summation
#: order, and the two libraries' exp/erf/tanh differ in the last bits)
TOL = 1e-4
#: f32 loss, relative
LOSS_REL = 1e-5
#: f32 gradients and one optimizer step's parameters, relative L2 per leaf
GRAD_REL_L2 = 1e-4


def cfgs(name, **over):
    """(JAX config, port config): ``name`` reduced, f32, with ``over``."""
    over = {"param_dtype": "float32", **over}
    return (j_config(name).reduced().with_overrides(**over),
            t_config(name).reduced().with_overrides(**over))


@functools.lru_cache(maxsize=None)
def tree(name, seed=0):
    """The reduced f32 model's weights in the JAX package's tree, as numpy."""
    _, tc = cfgs(name)
    return params_to_reference(t_build(tc).init(torch.Generator().manual_seed(seed)), tc)


def carried(name, **over):
    """(JAX bundle, JAX params, port bundle, port params, port config) on the
    same weights."""
    jc, tc = cfgs(name, **over)
    t = tree(name)
    return j_build(jc), jax.tree.map(jnp.asarray, t), t_build(tc), params_from_reference(t, tc), tc


def torch_dtype(np_dtype):
    """The torch dtype of a numpy leaf (``ml_dtypes``' bfloat16 included)."""
    name = np.dtype(np_dtype).name
    return torch.bfloat16 if name == "bfloat16" else getattr(torch, name)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol, err_msg=what)


def rel_l2(got, want) -> float:
    g, w = f32(got).astype(np.float64), f32(want).astype(np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12))


def leaves(t, path=()):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from leaves(v, (*path, k))
    else:
        yield "/".join(path), t


def hold_trees(got, want, tol, what):
    """Every leaf of ``got`` within relative L2 ``tol`` of ``want``'s; the
    same leaves in both."""
    got, want = dict(leaves(got)), dict(leaves(want))
    assert set(got) == set(want), what
    bad = {k: r for k in want if not (r := rel_l2(got[k], want[k])) <= tol}
    assert not bad, f"{what}: leaves beyond rel L2 {tol}: {bad}"


def numpy_tree(t):
    if isinstance(t, dict):
        return {k: numpy_tree(v) for k, v in t.items()}
    return t.detach().float().numpy()


def grads_tree(module, grads):
    """The port's ``{name: gradient}`` in the JAX package's tree, as f32
    numpy."""
    return numpy_tree(reference_tree(module, grads))


def close_caches(got, want, tol=TOL, what="cache"):
    """Every leaf of the JAX cache ``want`` in the port's ``got``: integers
    exactly, floats within ``tol``."""
    assert set(got) == set(want), what
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == tuple(w.shape), (what, k, tuple(g.shape), w.shape)
        if np.issubdtype(np.asarray(w).dtype, np.integer):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{what} {k}")
        else:
            close(g, w, tol, f"{what} {k}")


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(name, batch_key):
    """The JAX package's f32 ``train_loss`` and gradients (numpy) of the
    reduced ``name`` at the batch ``batch_key`` names (a tuple of (key,
    numpy bytes, shape, dtype)), one compile per architecture."""
    jb, jp, *_ = carried(name)
    batch = {k: jnp.asarray(np.frombuffer(b, dtype).reshape(shape))
             for k, b, shape, dtype in batch_key}
    loss, grads = jax.jit(jax.value_and_grad(jb.train_loss))(jp, batch)
    return float(loss), jax.tree.map(np.asarray, grads)


def batch_key(batch):
    """A hashable form of a numpy batch (``jax_loss_and_grads``'s key)."""
    return tuple((k, v.tobytes(), v.shape, v.dtype.str) for k, v in sorted(batch.items()))


def hold_loss_and_grads(name, batch, impl):
    """The port's ``train_loss`` and gradients (through ``impl`` attention)
    against the JAX package's (its chunked attention, the oracle of its
    flash kernel) at ``batch``."""
    _, _, tb, tp, _ = carried(name, attn_impl=impl)
    jl, jg = jax_loss_and_grads(name, batch_key(batch))
    loss, grads = tb.value_and_grad(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), jl, rtol=LOSS_REL)
    hold_trees(grads_tree(tp, grads), jg, GRAD_REL_L2, f"{name} {impl} gradients")


def hold_train_step(name, batch, lr=3e-4):
    """One port ``bundle.train_step``: its loss against the JAX package's
    (rel ``LOSS_REL``), and its parameters against the JAX ``adamw_update``
    of the port's own gradients (rel L2 ``GRAD_REL_L2`` per leaf; those
    gradients are held against JAX's by ``hold_loss_and_grads``). Against
    the JAX gradients the step is not held: Adam's first update is
    lr·g/(|g|+eps), and where |g| is a few eps (the zero-initialised norm
    scales have such elements) the two libraries' last bits of g move it by
    a percent."""
    from repro.optim.adamw import adamw_update

    jb, jp, tb, tp, tc = carried(name)
    jl, _ = jax_loss_and_grads(name, batch_key(batch))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, grads = tb.value_and_grad(tp, tbatch)
    want, _ = jax.jit(functools.partial(adamw_update, lr=lr))(
        jax.tree.map(jnp.asarray, grads_tree(tp, grads)), jb.init_opt(jp), jp)
    tp, topt, tl = tb.train_step(tp, tb.init_opt(tp), tbatch, lr=lr)
    np.testing.assert_allclose(float(tl), jl, rtol=LOSS_REL)
    assert int(topt["step"]) == 1
    hold_trees(params_to_reference(tp, tc), jax.tree.map(np.asarray, want), GRAD_REL_L2,
               f"{name} parameters after one step")


def jax_fields(t: dict) -> dict:
    """A port config's fields (``dataclasses.asdict``) that the JAX
    package's ``ArchConfig`` has; the fields only the port has (the layouts
    and scalars of ``granite-4.0-h-small``, which the JAX package lacks)
    are held at their defaults first, so every config the two packages
    share is the JAX package's, field for field, and no more."""
    shared = {f.name for f in dataclasses.fields(JArchConfig)}
    extra = {f.name: f.default for f in dataclasses.fields(TArchConfig)
             if f.name not in shared}
    assert {k: t[k] for k in extra} == extra, t["name"]
    return {k: v for k, v in t.items() if k in shared}
