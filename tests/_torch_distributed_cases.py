"""Cases run alike by the JAX package and the torch port, for
tests/test_torch_sharding.py, tests/test_torch_moe_ep.py and
tests/test_torch_pipeline.py.

Each case is made from numpy seeds (or from the JAX package's own PRNG
draws, passed across as numpy), so one definition serves both packages;
tests/_torch_distributed_main.py runs the JAX side at p = 8 on fake XLA
host devices and writes the results to an ``.npz``.
"""
from __future__ import annotations

import numpy as np

P8 = 8

#: meshes the factories build on 8 devices: (factory, args) → both packages
MESH_FACTORIES = (
    ("make_local_mesh", (8, 1)), ("make_local_mesh", (4, 2)),
    ("make_local_mesh", (2, 4)), ("make_local_mesh", (1, 8)),
    ("make_local_mesh", (1, 1)), ("make_pp_mesh", (4,)), ("make_pp_mesh", (4, 2)),
    ("make_pp_mesh", (2, 4)),
)

#: placements held against ``NamedSharding.devices_indices_map``: (mesh
#: shape, axis names, spec entries, leaf shape)
PLACEMENTS = (
    ((4, 2), ("data", "model"), ("data", "model"), (8, 6)),
    ((4, 2), ("data", "model"), (None, "data"), (3, 8)),
    ((4, 2), ("data", "model"), (("data", "model"), None), (16, 3)),
    ((4, 2), ("data", "model"), (("model", "data"),), (8,)),
    ((4, 2), ("data", "model"), (), (5, 7)),
    ((8, 1), ("data", "model"), (None, "data", None, "model"), (2, 8, 4, 6)),
    ((2, 2, 2), ("pod", "data", "model"), (("pod", "data"), None, "model"), (4, 3, 2)),
    ((2, 2, 2), ("pod", "data", "model"), ("model", "pod"), (6, 4)),
    ((4, 2), ("stage", "data"), ("stage",), (4, 5)),
)

# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------

#: (E, K, D, F): the JAX package's own EP case (tests/_distributed_main.py)
EP_DIMS = (8, 2, 32, 64)
#: name → (capacity factor, x shape, seed). ``nodrop`` is the JAX package's
#: own case (its x and weights are its PRNG draws); at 16 x 16 tokens each
#: rank routes T_loc = 32, so C = max(int(cf·32·2/8), 2): 10 at 1.25 and 4
#: at 0.5, which drop tokens, where the flat path's capacity over all 256
#: tokens is 80 and 32.
EP_CASES = {
    "nodrop": (8.0, (16, 4, 32), None),
    "cf1.25": (1.25, (16, 16, 32), 11),
    "cf0.5": (0.5, (16, 16, 32), 12),
}
#: the multiplier of the aux loss in the loss whose gradients are held
AUX_WEIGHT = 3.0


def ep_inputs(seed: int, x_shape):
    """(x, params, cotangent of y) of a seeded case, f32 numpy."""
    E, _K, D, F = EP_DIMS
    g = np.random.default_rng(seed)
    sc = lambda fan: 1.0 / np.sqrt(fan)  # noqa: E731
    params = {
        "router": (g.standard_normal((D, E)) * sc(D)).astype(np.float32),
        "w_gate": (g.standard_normal((E, D, F)) * sc(D)).astype(np.float32),
        "w_up": (g.standard_normal((E, D, F)) * sc(D)).astype(np.float32),
        "w_down": (g.standard_normal((E, F, D)) * sc(F)).astype(np.float32),
    }
    x = g.standard_normal(x_shape).astype(np.float32)
    gy = g.standard_normal(x_shape).astype(np.float32)
    return x, params, gy


#: the ``ep_applicable`` truth table: (moe_ep, mesh (data, model) or None,
#: num_experts) at a batch every mesh's data axis divides
EP_RULE = tuple(
    (ep, mesh, E)
    for ep in (True, False)
    for mesh in (None, (8, 1), (4, 2), (2, 4), (1, 8))
    for E in (8, 6, 4)
)
EP_RULE_BATCH = 16
#: shapes the JAX ``moe_apply`` cannot split and so takes flat (its EP
#: raises and is caught): batch 4 on 8 data ranks, at prefill (S = 4) and at
#: decode (4 slots, S = 1)
EP_FLAT_SHAPES = ((4, 4, 32), (4, 1, 32))

# ---------------------------------------------------------------------------
# the pipeline schedule
# ---------------------------------------------------------------------------

#: name → (stages S, microbatches M, mb, d, dict params?). ``jax`` is the JAX
#: package's own case (tests/_distributed_main.py: its PRNG draws).
PIPE_CASES = {
    "jax": (4, 8, 2, 16, False),
    "one_stage": (1, 1, 2, 16, False),
    "m_below_s": (4, 2, 2, 16, False),
    "dict": (4, 5, 3, 8, True),
}
PIPE_ATOL = 1e-5


def pipe_inputs(name: str, seed: int = 5):
    """(stage params, x_micro) of a seeded case (not ``jax``), f32 numpy."""
    S, M, mb, d, as_dict = PIPE_CASES[name]
    g = np.random.default_rng(seed)
    w = (g.standard_normal((S, d, d)) * 0.3).astype(np.float32)
    x = g.standard_normal((M, mb, d)).astype(np.float32)
    if as_dict:
        return {"w": w, "b": (g.standard_normal((S, d)) * 0.1).astype(np.float32)}, x
    return w, x


def stage_fn(xp):
    """``tanh(x @ W)`` (or ``tanh(x @ w + b)`` for dict params), written
    against an array namespace ``xp`` (jnp or torch)."""
    def fn(p, x):
        if isinstance(p, dict):
            return xp.tanh(x @ p["w"] + p["b"])
        return xp.tanh(x @ p)
    return fn
