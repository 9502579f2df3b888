"""The port's sharding rules and meshes (``repro_torch.distributed.sharding``,
``repro_torch.launch.mesh``) against the JAX package's, on the CPU.

For every config of ``list_configs()`` at full width — abstract shapes
only: ``jax.eval_shape`` of the JAX bundle's ``init`` and ``init_opt``, the
port's model and optimizer state on the ``meta`` device in the JAX tree
(``interop.reference_tree``/``opt_tree``) — ``param_specs``, ``opt_specs``
(with and without ``_zero1``), ``cache_specs``, ``input_specs_sharding``
and ``lead_axes`` are held spec for spec, over the presets ``dp``,
``fsdp``, ``fsdp_tp`` and ``tp``, ``attn_sp`` on and off, on the meshes
(16, 16), (2, 16, 16), (8, 1), (4, 2), (5, 1) and (1, 1). The JAX rules read
only ``mesh.axis_names`` and ``mesh.shape``, so they take a stand-in with
those two attributes. The mesh factories and ``to_named``'s placements
(which rank holds which slice) are held against JAX's on 8 fake devices in
one subprocess (tests/_torch_distributed_main.py sharding)."""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_distributed_cases as cases  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import list_configs  # noqa: E402
from repro.configs.base import ShapeCell  # noqa: E402
from repro.distributed import sharding as js  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.distributed import sharding as ts  # noqa: E402
from repro_torch.interop import opt_tree, reference_tree  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models.model_zoo import (  # noqa: E402
    WHISPER_PREFILL_DEC,
    WHISPER_TRAIN_ENC,
    build_module,
)
from repro_torch.models.transformer import VIT_DIM  # noqa: E402
from repro_torch.optim.adamw import init_opt_state  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = list_configs()
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "8x1": ((8, 1), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "5x1": ((5, 1), ("data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}
PRESETS = ("dp", "fsdp", "fsdp_tp", "tp")
#: input cells (kind, batch, seq): the JAX shape cells and small batches
#: that take the fallbacks (no batch axis: the KV sequence over "data")
CELLS = (("train", 256, 4096), ("prefill", 32, 32768), ("decode", 128, 32768),
         ("decode", 1, 524288), ("train", 5, 4096), ("prefill", 3, 4096),
         ("decode", 4, 4096), ("decode", 10, 4096))
BATCHES = tuple(range(1, 41)) + (64, 96, 128, 256, 320, 512, 1024)


class StandIn:
    """What the JAX rules read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


def flat(tree, pre=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, (*pre, k)))
        return out
    return {pre: tree}


def same_specs(a, b, what):
    fa, fb = flat(a), flat(b)
    assert set(fa) == set(fb), (what, set(fa) ^ set(fb))
    for k in fa:
        assert tuple(fa[k]) == tuple(fb[k]), (what, k, fa[k], fb[k])
        assert isinstance(fb[k], ts.PartitionSpec), (what, k, type(fb[k]))
    return len(fa)


@functools.lru_cache(maxsize=None)
def abstract(name):
    """(JAX params, JAX opt, port params, port opt): shapes only."""
    jb = jbuild(jget(name))
    jp = jax.eval_shape(jb.init, jax.random.PRNGKey(0))
    jo = jax.eval_shape(jb.init_opt, jp)
    tc = tget(name)
    mod = build_module(tc, device="meta")
    tp = reference_tree(mod, leaf=lambda t: t)
    to = opt_tree(mod, init_opt_state(mod, getattr(torch, tc.opt_moment_dtype)),
                  leaf=lambda t: t)
    return jp, jo, tp, to


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def port_inputs(cfg, kind, B, S):
    """The port's batch for a cell, as the JAX bundle's ``input_specs``
    shapes it; decode caches from the port's own ``make_cache``."""
    i32, bf16 = torch.int32, torch.bfloat16
    if kind == "decode":
        cache = tbuild(cfg).make_cache(B, S, device="meta")
        return {"cache": cache, "tokens": _meta((B, 1), i32)}
    if cfg.family == "audio":
        if kind == "train":
            return {"frames": _meta((B, WHISPER_TRAIN_ENC, cfg.d_model), bf16),
                    "tokens": _meta((B, S), i32), "labels": _meta((B, S), i32)}
        return {"frames": _meta((B, S, cfg.d_model), bf16),
                "tokens": _meta((B, WHISPER_PREFILL_DEC), i32)}
    if cfg.family == "vlm":
        n = cfg.num_patches
        out = {"tokens": _meta((B, S - n), i32), "patches": _meta((B, n, VIT_DIM), bf16)}
        if kind == "train":
            out["labels"] = _meta((B, S - n), i32)
        return out
    out = {"tokens": _meta((B, S), i32)}
    if kind == "train":
        out["labels"] = _meta((B, S), i32)
    return out


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in flat(tree).items()}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_specs_equal_the_reference(name, mesh_name):
    shape, names = MESHES[mesh_name]
    jm = StandIn(shape, names)
    tm = tmesh.Mesh(shape, names, device="cpu")
    jp, jo, tp, to = abstract(name)
    assert _shapes(jp) == _shapes(tp) and _shapes(jo) == _shapes(to)
    n = 0
    for preset in PRESETS:
        for zero1 in ("", "_zero1"):
            for sp in (False, True):
                over = dict(sharding_preset=preset + zero1, attn_sp=sp)
                jc, tc = jget(name).with_overrides(**over), tget(name).with_overrides(**over)
                jpsp, tpsp = js.param_specs(jp, jc, jm), ts.param_specs(tp, tc, tm)
                n += same_specs(jpsp, tpsp, ("param", over))
                n += same_specs(js.opt_specs(jo, jpsp, jc, jm),
                                ts.opt_specs(to, tpsp, tc, tm), ("opt", over))
            # inputs and caches read the preset, not attn_sp
            for kind, B, S in CELLS:
                ji = jbuild(jc).input_specs(ShapeCell("cell", S, B, kind))
                ti = port_inputs(tc, kind, B, S)
                assert _shapes(ji) == _shapes(ti), (kind, B, S)
                n += same_specs(js.input_specs_sharding(ji, jc, jm, kind),
                                ts.input_specs_sharding(ti, tc, tm, kind), (kind, B, S))
                if kind == "decode":
                    n += same_specs(js.cache_specs(ji["cache"], jc, jm),
                                    ts.cache_specs(ti["cache"], tc, tm), ("cache", B, S))
            for B in BATCHES:
                for kind in ("train", "decode"):
                    assert js.lead_axes(jc, jm, B, kind) == ts.lead_axes(tc, tm, B, kind)
    assert ts.batch_axes(tm) == js.batch_axes(jm)
    assert n > 0


def test_the_model_itself_gives_the_same_specs():
    """``param_specs`` of the port's model (a module) reads its leaf names
    from ``reference_tree``, as the tree itself does."""
    cfg = tget("phi3.5-moe-42b-a6.6b").with_overrides(sharding_preset="fsdp_tp")
    mod = build_module(cfg, device="meta")
    m = tmesh.make_local_mesh(4, 2, device="cpu")
    same_specs(ts.param_specs(reference_tree(mod, leaf=lambda t: t), cfg, m),
               ts.param_specs(mod, cfg, m), "module")


def test_partition_spec_normalises_as_jax():
    from jax.sharding import PartitionSpec as JP

    P = ts.PartitionSpec
    for parts in [(), (None,), ("data",), (("data",),), ((),), (("pod", "data"), None),
                  ("data", None), (None, "model", None), (["data"], ("model",))]:
        assert tuple(P(*parts)) == tuple(JP(*parts)), parts
    assert P(("data",)) == P("data") and P(()) == P(None)
    assert P() != P(None) and P("data", None) != P("data")
    assert P("data") == ("data",)


def test_production_mesh_factories_equal_the_reference(monkeypatch):
    """The production meshes need 256 or 512 devices: the JAX factories run
    with ``make_mesh`` recording its arguments."""
    monkeypatch.setattr(jmesh, "make_mesh", lambda shape, axes: StandIn(shape, axes))
    for multi in (False, True):
        j = jmesh.make_production_mesh(multi_pod=multi)
        t = tmesh.make_production_mesh(multi_pod=multi, device="cpu")
        assert (t.axis_names, t.shape) == (j.axis_names, j.shape)
        assert t.size == (512 if multi else 256)
    assert tmesh.make_production_mesh().device == torch.device("cuda")
    assert tmesh.make_local_mesh(2, 2).device == torch.device("cuda")


@pytest.fixture(scope="module")
def jax_sharding(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharding") / "sharding.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, os.path.join(HERE, "_torch_distributed_main.py"),
                        "sharding", str(out)], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0 and "TORCH_DISTRIBUTED_JAX_OK" in r.stdout, r.stderr[-3000:]
    z = np.load(out)
    return {k: z[k] for k in z.files}


@pytest.mark.parametrize("i", range(len(cases.MESH_FACTORIES)))
def test_mesh_factories_equal_the_reference(jax_sharding, i):
    factory, args = cases.MESH_FACTORIES[i]
    want = json.loads(str(jax_sharding["meshes"]))[i]
    m = getattr(tmesh, factory)(*args, device="cpu")
    assert list(m.axis_names) == want["names"]
    assert m.shape == want["shape"]
    assert m.size == int(np.prod(list(want["shape"].values())))


@pytest.mark.parametrize("i", range(len(cases.PLACEMENTS)))
def test_placement_is_the_named_sharding(jax_sharding, i):
    """Rank r (row-major over the mesh's axes, a JAX mesh's ``devices.flat``
    order) holds the slice ``devices_indices_map`` gives device r."""
    shape, names, spec, leaf = cases.PLACEMENTS[i]
    m = tmesh.Mesh(shape, names, device="cpu")
    pl = ts.to_named({"w": ts.PartitionSpec(*spec)}, m,
                     {"w": torch.empty(leaf, dtype=torch.float32, device="meta")})["w"]
    want = jax_sharding[f"placement|{i}"]
    got = np.asarray([pl.index(r) for r in range(m.size)], np.int64).reshape(want.shape)
    np.testing.assert_array_equal(got, want)
    pieces = {pl.index(r) for r in range(m.size)}
    assert pl.rank_bytes * len(pieces) == int(np.prod(leaf)) * 4


def test_placement_rejects_what_it_cannot_place():
    m = tmesh.make_local_mesh(4, 2, device="cpu")
    P = ts.PartitionSpec
    with pytest.raises(ValueError, match="divide"):
        ts.Placement(m, P("data"), (6,), 4)
    with pytest.raises(ValueError, match="stage"):
        ts.Placement(m, P("stage"), (8,), 4)
    with pytest.raises(ValueError, match="twice"):
        ts.Placement(m, P("data", "data"), (8, 8), 4)
    with pytest.raises(ValueError, match="entries"):
        ts.Placement(m, P(None, None), (8,), 4)


def test_the_ranks_pieces_tile_the_leaf():
    m = tmesh.make_local_mesh(4, 2, device="cpu")
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    pl = ts.Placement(m, ts.PartitionSpec("data", "model"), x.shape, 4)
    back = torch.zeros_like(x)
    for r in range(m.size):
        (a, b), (c, d) = pl.index(r)
        back[a:b, c:d] = x[a:b, c:d]
        assert m.coords(r) == {"data": a // 2, "model": c // 3}
    assert torch.equal(back, x)
    assert pl.rank_bytes == 8 * 6 * 4 // 8
