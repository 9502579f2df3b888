"""Text lambdas + ISource (paper §4.2, Fig. 8).

IgnisHPC ships operator source as text so the driver language need not match
the executor language. Here the "executor language" is torch: a text lambda
is compiled by the executor into a row function with torch/np/math in scope.
ISource wraps a function reference plus driver→executor parameters (paper
Fig. 11's ``addParam``).
"""
from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch

_NAMESPACE = {"torch": torch, "np": np, "math": math}


def text_lambda(src: str) -> Callable:
    """Compile ``"lambda x: …"`` or ``"def fn(x): …"`` source text."""
    src = src.strip()
    scope = dict(_NAMESPACE)
    if src.startswith("lambda"):
        return eval(src, scope)  # noqa: S307 — executor-side operator compile
    exec(src, scope)  # noqa: S102
    fns = [v for k, v in scope.items() if callable(v) and k not in _NAMESPACE]
    if not fns:
        raise ValueError("text lambda defined no function")
    return fns[-1]


class ISource:
    """A function reference (callable, text, or registry name) + parameters."""

    def __init__(self, fn: Any):
        self.fn = fn
        self.params: dict[str, Any] = {}

    def add_param(self, name: str, value) -> "ISource":
        self.params[name] = value
        return self

    addParam = add_param

    def resolve(self) -> Callable:
        return resolve(self.fn)

    def token(self) -> tuple:
        """Hashable structural identity of (fn, params). Native call nodes
        embed this in their lineage signature (``node.sig``), so the plan
        caches key on the actual call — app *and* parameters."""
        from repro_torch.core.shuffle_plan import _static_token, fn_token

        f = self.fn if isinstance(self.fn, str) else fn_token(self.fn)
        return (f, tuple(sorted((k, _static_token(v)) for k, v in self.params.items())))


def resolve(fn) -> Callable:
    """Accept a callable, a text lambda, or an ISource; return a callable."""
    if fn is None:
        return None
    if isinstance(fn, ISource):
        return fn.resolve()
    if isinstance(fn, str):
        return text_lambda(fn)
    if callable(fn):
        return fn
    raise TypeError(f"cannot resolve operator from {type(fn)}")
