"""Build and load the port's CUDA C++ kernels (``src/repro_torch/csrc``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, under ``build/kernels/cuda/`` (listed in
.gitignore), and loaded with ``ctypes``. The build happens at the first
launch, once per process under a lock; the library's file name carries a
hash of the sources and flags, so an edited kernel is rebuilt. A failed
build raises: nothing falls back. Only a CUDA launch calls ``load``, so
importing the port needs no ``nvcc``.

Every library exports its entry points, which return a CUDA error code (0
on success), and ``<name>_error_string``; ``entry`` declares an entry
point's argument types and ``raise_on_error`` turns a code into a
``RuntimeError``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

from repro_torch.kernels import BUILD_DIR

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return str(pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def library_path(name: str) -> pathlib.Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the kernel and any shared header
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.read_bytes())
    return BUILD_DIR / "cuda" / f"{name}-{h.hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed (the
    program span ``kernel.build``: the library, the seconds, and whether
    nvcc ran or the cached library was found)."""
    from repro_torch.profile.spans import span

    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        with span("kernel.build") as sp:
            out = library_path(name)
            built = not out.exists()
            if built:
                out.parent.mkdir(parents=True, exist_ok=True)
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
                r = subprocess.run(cmd, capture_output=True, text=True)
                if r.returncode != 0:
                    raise RuntimeError(f"nvcc failed to build {name}.cu "
                                       f"(exit {r.returncode}):\n{r.stderr[-8000:]}")
                os.replace(tmp, out)
            lib = _libs[name] = ctypes.CDLL(str(out))
            if sp:
                sp.args.update(library=out.name, seconds=time.perf_counter() - sp.t0,
                               nvcc=built)
        return lib


def entry(name: str, symbol: str, argtypes: list):
    """The C entry point ``symbol`` of ``csrc/<name>.cu`` with its argument
    types declared (a pointer passed without ``c_void_p`` would be cut to
    32 bits) and an ``int`` error code as its result."""
    fn = getattr(load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def raise_on_error(name: str, err: int, what: str) -> None:
    """Raise ``RuntimeError`` for a non-zero error code of ``name``'s
    library, with CUDA's message for it."""
    if err == 0:
        return
    to_str = getattr(load(name), f"{name}_error_string")
    to_str.argtypes = [ctypes.c_int]
    to_str.restype = ctypes.c_char_p
    msg = to_str(err)
    raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                       f"({msg.decode() if msg else '?'})")
