"""Checkpoint / restart (fault tolerance, paper §3.5 adapted).

Layout: <dir>/step_<N>/  manifest.json + one .npy per leaf (path-keyed),
the JAX package's format byte for byte: a tree saved by either package
restores in the other. The manifest records logical shapes/dtypes + content
hashes, so restore can (1) verify integrity, (2) place leaves on any device
the caller names.

Leaves are torch tensors (any device) or numpy arrays. bf16, which numpy
cannot hold, is stored as its uint16 view under ``"dtype": "bfloat16"``.

AsyncCheckpointer overlaps serialization with the caller's next step: the
device→host copies happen on ``save``, a background thread writes them.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch


def _flatten(tree) -> dict:
    """``{path key: leaf}`` with keys joined as the JAX package joins a
    pytree path (dict keys, sequence indices; ``None`` holds no leaf)."""
    out: dict = {}
    _flatten_into(tree, (), out)
    return out


def _flatten_into(x, path, out: dict):
    # module-level recursion: a nested recursive function is a reference
    # cycle that would hold the leaves until the cyclic collector runs
    if x is None:
        return
    if isinstance(x, dict):
        for k in sorted(x):
            _flatten_into(x[k], path + (k,), out)
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            _flatten_into(v, path + (i,), out)
    else:
        out["/".join(str(p) for p in path)] = x


def _rebuild(tree, leaves: dict, path=()):
    """``tree``'s structure with each leaf replaced by ``leaves[key]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves, path + (k,)) for k in tree}
    if isinstance(tree, (tuple, list)):
        vals = [_rebuild(v, leaves, path + (i,)) for i, v in enumerate(tree)]
        return tuple(vals) if isinstance(tree, tuple) else vals
    return leaves["/".join(str(p) for p in path)]


def _host(v) -> tuple[np.ndarray, str]:
    """One leaf as ``(host array as stored, manifest dtype)``: bf16 (and
    JAX's ml_dtypes, which numpy cannot serialise) as their unsigned-int
    view under their own dtype name."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    a = np.asarray(v)
    if a.dtype.kind == "V" or "bfloat16" in str(a.dtype) or "float8" in str(a.dtype):
        return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint8), str(a.dtype)
    return a, str(a.dtype)


_TORCH = {name: getattr(torch, name) for name in (
    "bool", "uint8", "int8", "int16", "int32", "int64", "uint16", "uint32",
    "uint64", "float16", "float32", "float64", "complex64", "complex128")
    if hasattr(torch, name)}


def _to_torch(arr: np.ndarray, dtype_str: str, device) -> torch.Tensor:
    """A stored leaf as a tensor on ``device`` in its manifest dtype."""
    arr = np.require(arr, requirements="C")  # keeps 0-d leaves 0-d
    if dtype_str == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    elif dtype_str in _TORCH:
        t = torch.from_numpy(arr.view(np.dtype(dtype_str)))
    else:
        raise TypeError(f"checkpoint leaf dtype {dtype_str!r} has no torch counterpart")
    return t.to(device)


def save(ckpt_dir: str, step: int, tree: Any, keep: int = 3) -> str:
    """Blocking save. Returns the step directory."""
    host = {k: _host(v) for k, v in _flatten(tree).items()}
    return _write(ckpt_dir, step, host, keep)


def _write(ckpt_dir: str, step: int, host: dict, keep: int) -> str:
    sdir = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = sdir + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for i, (k, (v, dtype)) in enumerate(sorted(host.items())):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), v)
        with open(os.path.join(tmp, fname), "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        manifest["leaves"][k] = {
            "file": fname,
            "shape": list(v.shape),
            "dtype": dtype,
            "sha256_16": digest,
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(sdir):
        shutil.rmtree(sdir)
    os.rename(tmp, sdir)  # atomic publish
    _gc(ckpt_dir, keep)
    return sdir


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return int(steps[-1].split("_")[1]) if steps else None


def restore(ckpt_dir: str, step: int, target: Any, device,
            verify: bool = True) -> Any:
    """Restore into the structure of ``target`` (a tree of tensors, numpy
    arrays or anything with a ``shape``, e.g. ``meta`` tensors), every leaf
    a tensor on ``device`` — the placement the caller asks for; there is no
    default. A leaf whose bytes do not hash to the manifest's raises
    ``IOError``; a shape that disagrees with the target raises
    ``ValueError``."""
    sdir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(sdir, "manifest.json")) as f:
        manifest = json.load(f)
    device = torch.device(device)
    out = {}
    for k, leaf in _flatten(target).items():
        meta = manifest["leaves"][k]
        path = os.path.join(sdir, meta["file"])
        with open(path, "rb") as f:
            raw = f.read()
        if verify and hashlib.sha256(raw).hexdigest()[:16] != meta["sha256_16"]:
            raise IOError(f"checkpoint corruption in leaf {k!r}")
        arr = np.load(io.BytesIO(raw))
        expect = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != expect:
            raise ValueError(f"leaf {k!r}: checkpoint {arr.shape} != target {expect}")
        out[k] = _to_torch(arr, meta["dtype"], device)
    return _rebuild(target, out)


class AsyncCheckpointer:
    """Background-thread writer: the device→host copy happens on ``save``,
    serialization happens off-thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None

    def save(self, step: int, tree: Any):
        self.wait()
        host = {k: _host(v) for k, v in _flatten(tree).items()}

        def run():
            self.last_path = _write(self.dir, step, host, self.keep)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
