"""Native SPMD app execution (paper §5, Figs. 9–11).

IgnisHPC runs MPI applications by (1) removing MPI_Init/Finalize — the
framework owns the environment — and (2) swapping MPI_COMM_WORLD for the
framework's communicator. The torch analogue: a native app is a function
``fn(ctx, *tensors, **params)`` whose body runs over every rank of
``ctx`` at once (flat rank-major tensors, ``core/comm.py`` collectives).
``ignis_export`` registers it in a library; ``worker.load_library`` +
``worker.call`` execute it — the +17…75 SLOC integration the paper's
Table 5 measures is exactly the export wrapper.
"""
from __future__ import annotations

import importlib
import importlib.util
import sys
from typing import Callable

_REGISTRY: dict[str, Callable] = {}


def ignis_export(name: str | None = None):
    """Decorator: register a native app under ``name`` (paper's
    ``ignis_export(Class, Name)`` / ``create_ignis_library``)."""

    def deco(fn):
        _REGISTRY[name or fn.__name__] = fn
        return fn

    if callable(name):  # bare @ignis_export
        fn, nm = name, name.__name__
        _REGISTRY[nm] = fn
        return fn
    return deco


def load_library(path_or_module: str) -> list[str]:
    """Import a library module, returning the names it exported."""
    before = set(_REGISTRY)
    if path_or_module.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            f"ignis_lib_{abs(hash(path_or_module))}", path_or_module
        )
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
    else:
        importlib.import_module(path_or_module)
    return sorted(set(_REGISTRY) - before)


def get_app(name: str) -> Callable:
    if name not in _REGISTRY:
        raise KeyError(f"native app {name!r} not loaded; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]
