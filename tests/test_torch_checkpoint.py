"""The port's checkpoint format, held against the JAX package's: a tree
saved by either package restores in the other bit for bit (bf16 included),
and the same tree saved at the same step by both gives byte-identical
``.npy`` files and equal manifests. Then the port's own round trip, device
placement, integrity check, GC, async writer and shape check, and a frame's
checkpoint (``IDataFrame.checkpoint``) written alike by both packages."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.checkpoint as jck  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro_torch.checkpoint as tck  # noqa: E402
import repro_torch.core as tcore  # noqa: E402


def _host_tree():
    r = np.random.default_rng(0)
    return {
        "params": {"w": r.standard_normal((8, 8)).astype(np.float32),
                   "b": np.zeros((8,), np.float32),
                   "emb": r.standard_normal((5, 4)).astype(np.float32)},
        "opt": {"m": np.ones((3,), np.float32), "step": np.asarray(7, np.int32),
                "mask": r.integers(0, 2, (6,)).astype(bool)},
        "ids": [r.integers(-9, 9, (4, 2)).astype(np.int32), np.asarray(3, np.int64)],
    }


def _jax_tree():
    t = jax.tree.map(jnp.asarray, _host_tree())
    t["params"]["emb"] = t["params"]["emb"].astype(jnp.bfloat16)
    t["ids"][1] = _host_tree()["ids"][1]  # a numpy leaf: jax arrays hold no int64 here
    return t


def _torch_tree():
    t = {k: ({kk: torch.as_tensor(vv) for kk, vv in v.items()} if isinstance(v, dict)
             else [torch.as_tensor(x) for x in v]) for k, v in _host_tree().items()}
    t["params"]["emb"] = t["params"]["emb"].to(torch.bfloat16)
    t["ids"][1] = _host_tree()["ids"][1]
    return t


def _bits(x) -> np.ndarray:
    """A leaf's raw bits, bf16 as its uint16 view."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if str(a.dtype) == "bfloat16" else a


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _leaves(v)]
    return [t]


def _same_bits(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        bx, by = _bits(x), _bits(y)
        assert bx.dtype == by.dtype and bx.shape == by.shape and np.array_equal(bx, by)


def test_the_same_tree_saves_byte_identical(tmp_path):
    jdir = jck.save(str(tmp_path / "jax"), 12, _jax_tree())
    tdir = tck.save(str(tmp_path / "torch"), 12, _torch_tree())
    assert os.path.basename(jdir) == os.path.basename(tdir) == "step_00000012"
    with open(os.path.join(jdir, "manifest.json")) as f:
        jm = json.load(f)
    with open(os.path.join(tdir, "manifest.json")) as f:
        tm = json.load(f)
    assert tm == jm
    assert jm["leaves"]["params/emb"]["dtype"] == "bfloat16"
    assert sorted(jm["leaves"]) == ["ids/0", "ids/1", "opt/m", "opt/mask", "opt/step",
                                    "params/b", "params/emb", "params/w"]
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    for name in os.listdir(jdir):
        with open(os.path.join(jdir, name), "rb") as f, \
                open(os.path.join(tdir, name), "rb") as g:
            assert f.read() == g.read(), name


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jck.save(str(tmp_path), 3, _jax_tree())
    out = tck.restore(str(tmp_path), 3, _torch_tree(), "cpu")
    assert out["params"]["emb"].dtype == torch.bfloat16
    assert isinstance(out["ids"], list) and out["opt"]["step"].dtype == torch.int32
    _same_bits(out, _jax_tree())


def test_port_checkpoint_restores_in_jax(tmp_path):
    """What the JAX package restores from the port's checkpoint is what it
    restores from its own (it places every leaf as a jax array, so the
    int64 leaf comes back int32 from either)."""
    tck.save(str(tmp_path / "t"), 4, _torch_tree())
    jck.save(str(tmp_path / "j"), 4, _jax_tree())
    out = jck.restore(str(tmp_path / "t"), 4, _jax_tree())
    assert out["params"]["emb"].dtype == jnp.bfloat16
    _same_bits(out, jck.restore(str(tmp_path / "j"), 4, _jax_tree()))
    _same_bits(out["params"], _torch_tree()["params"])


def test_round_trip_lands_on_the_named_device(tmp_path):
    t = _torch_tree()
    tck.save(str(tmp_path), 5, t)
    assert tck.latest_step(str(tmp_path)) == 5
    out = tck.restore(str(tmp_path), 5, t, torch.device("cpu"))
    assert all(x.device == torch.device("cpu") for x in _leaves(out))
    _same_bits(out, t)
    meta = {k: ({kk: torch.as_tensor(vv).to("meta") for kk, vv in v.items()} if isinstance(v, dict)
                else [torch.as_tensor(x).to("meta") for x in v]) for k, v in t.items()}
    _same_bits(tck.restore(str(tmp_path), 5, meta, "cpu"), t)
    with pytest.raises(TypeError):
        tck.restore(str(tmp_path), 5, t)  # the device is not optional


def test_corruption_detected(tmp_path):
    sdir = tck.save(str(tmp_path), 1, _torch_tree())
    victim = sorted(f for f in os.listdir(sdir) if f.endswith(".npy"))[0]
    with open(os.path.join(sdir, victim), "r+b") as f:
        f.seek(100)
        f.write(b"\xde\xad")
    with pytest.raises(IOError, match="corruption"):
        tck.restore(str(tmp_path), 1, _torch_tree(), "cpu")


def test_gc_keeps_latest(tmp_path):
    for s in (1, 2, 3, 4, 5):
        tck.save(str(tmp_path), s, _torch_tree(), keep=2)
    assert sorted(os.listdir(str(tmp_path))) == ["step_00000004", "step_00000005"]
    assert tck.latest_step(str(tmp_path / "missing")) is None


def test_async_checkpointer(tmp_path):
    t = _torch_tree()
    ck = tck.AsyncCheckpointer(str(tmp_path), keep=2)
    ck.save(10, t)
    ck.wait()
    assert tck.latest_step(str(tmp_path)) == 10
    assert ck.last_path.endswith("step_00000010")
    _same_bits(tck.restore(str(tmp_path), 10, t, "cpu"), t)


def test_shape_mismatch_rejected(tmp_path):
    tck.save(str(tmp_path), 1, {"w": torch.zeros((4, 4))})
    with pytest.raises(ValueError, match="checkpoint"):
        tck.restore(str(tmp_path), 1, {"w": torch.zeros((5, 4))}, "cpu")


@pytest.mark.parametrize("blocks", [1, 2, 3])
def test_frame_checkpoint_matches_the_references(tmp_path, blocks):
    """``IDataFrame.checkpoint`` of the same rows writes the same leaves
    (the step is the node's id, which differs between the packages); the
    restored frame, and a block restored after a kill, give the rows back,
    committed to the worker's ranks."""
    rows = np.random.default_rng(blocks).integers(0, 1000, 37).astype(np.int32)

    def frame(core, props, d):
        w = core.IWorker(core.ICluster(core.IProperties(props)), "python")
        return w, (w.parallelize(rows, blocks=blocks)
                   .map(lambda x: {"key": x % 7, "value": x}).checkpoint(d))

    jw, jdf = frame(jcore, {}, str(tmp_path / "j"))
    tw, tdf = frame(tcore, {"ignis.device": "cpu"}, str(tmp_path / "t"))

    def manifest(d):
        (step,) = os.listdir(d)
        with open(os.path.join(d, step, "manifest.json")) as f:
            return json.load(f)["leaves"]

    assert manifest(str(tmp_path / "t")) == manifest(str(tmp_path / "j"))
    want = sorted((int(r["key"]), int(r["value"])) for r in jdf.collect())
    assert sorted((int(r["key"]), int(r["value"])) for r in tdf.collect()) == want
    tw.kill_executor(0, blacklist=False)
    assert tdf.node.result[0] is None
    assert sorted((int(r["key"]), int(r["value"])) for r in tdf.collect()) == want
    assert tw.metrics("stages")["block_restores"] == 1
    assert tdf.node.result[0].ranks == tw.context.ranks
