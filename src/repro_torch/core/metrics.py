"""Unified counter registry — the single backend behind every telemetry
surface (docs/profiling.md, DESIGN.md §13).

Every subsystem keeps its counters in one mechanism instead of ad-hoc
stats dicts:

* ``Counters`` is a named namespace of numeric counters. It IS a dict
  (``stats["x"] += 1`` and ``dict(stats)`` keep working verbatim at every
  existing call site), but it knows its namespace and registers per-key
  docstrings, so a metrics tree can be assembled and documented from the
  pieces.
* ``MetricsTree`` mounts namespaces (``Counters`` instances, snapshot
  callables, or nested trees) under path segments and snapshots them into
  one nested dict: ``worker.metrics()`` → ``{"stages": {...}, "shuffle":
  {...}, "coll": {...}, "kernels": {...}, "profile": {...}}``.

The older accessors (``worker.stage_stats()``, ``worker.shuffle_stats()``,
``job.stats()["coll"]``) remain as thin facades over subtree snapshots with
the same counter names and merged shapes. New code should read the tree
(docs/profiling.md has the old→new migration table).
"""
from __future__ import annotations

import warnings
from typing import Callable, Mapping, Optional, Union


class Counters(dict):
    """A namespace of numeric counters inside a metrics tree.

    A plain ``dict`` in every behavioural respect — subsystems mutate it
    under their own locks exactly as before — plus a namespace name and
    optional per-key documentation used by the metrics tree and the docs
    tooling. Unknown-key writes are allowed (streaming telemetry grows keys
    per tenant); ``describe()`` returns whatever docs were registered.
    """

    __slots__ = ("namespace", "_docs")

    def __init__(self, namespace: str, initial: Optional[Mapping] = None,
                 docs: Optional[Mapping[str, str]] = None):
        super().__init__(initial or {})
        self.namespace = namespace
        self._docs = dict(docs or {})

    def describe(self) -> dict:
        """{counter: docstring} for every documented counter."""
        return dict(self._docs)

    def snapshot(self) -> dict:
        return dict(self)

    def __repr__(self):
        return f"Counters({self.namespace!r}, {dict.__repr__(self)})"


Source = Union[Counters, Callable[[], Mapping], "MetricsTree", Mapping]


class MetricsTree:
    """A mounted tree of counter namespaces.

    Each mount point is a ``Counters`` instance (live — snapshots read the
    current values), a zero-arg callable returning a mapping (for
    process-wide or lazily-computed sources like ``comm.comm_stats``), a
    nested ``MetricsTree``, or a plain mapping. ``snapshot()`` renders the
    whole tree as nested plain dicts; ``snapshot(path)`` renders one
    subtree. Mount points can be replaced (a worker re-wiring a subsystem
    re-mounts the same path).
    """

    __slots__ = ("_mounts",)

    def __init__(self, **mounts: Source):
        self._mounts: dict[str, Source] = {}
        for name, src in mounts.items():
            self.mount(name, src)

    def mount(self, name: str, source: Source) -> "MetricsTree":
        if "/" in name:
            head, rest = name.split("/", 1)
            sub = self._mounts.get(head)
            if not isinstance(sub, MetricsTree):
                sub = MetricsTree()
                self._mounts[head] = sub
            sub.mount(rest, source)
            return self
        self._mounts[name] = source
        return self

    def unmount(self, name: str):
        self._mounts.pop(name, None)

    def names(self) -> list[str]:
        return sorted(self._mounts)

    @staticmethod
    def _render(src: Source) -> dict:
        if isinstance(src, MetricsTree):
            return src.snapshot()
        if isinstance(src, Counters):
            return src.snapshot()
        if callable(src):
            return dict(src())
        return dict(src)

    def snapshot(self, path: str | None = None) -> dict:
        """Nested plain-dict snapshot of the tree (or of one ``path``
        subtree, ``/``-separated). Unknown paths raise ``KeyError`` with
        the known mount names — a misspelt subsystem should fail loudly,
        not read as zero activity."""
        if path:
            head, _, rest = path.partition("/")
            if head not in self._mounts:
                raise KeyError(
                    f"no metrics namespace {head!r} (have: {self.names()})")
            src = self._mounts[head]
            if rest:
                if not isinstance(src, MetricsTree):
                    snap = self._render(src)
                    if rest in snap:
                        return snap[rest]
                    raise KeyError(f"no metrics path {path!r}")
                return src.snapshot(rest)
            return self._render(src)
        return {name: self._render(src) for name, src in self._mounts.items()}


# ---------------------------------------------------------------------------
# deprecation plumbing for the old accessors
# ---------------------------------------------------------------------------

_warned: set[str] = set()


def warn_deprecated(old: str, new: str):
    """One ``DeprecationWarning`` per (old, new) pair per process — the old
    accessors keep working (facades over the metrics tree) but new code
    should read ``metrics()`` (docs/profiling.md migration table)."""
    key = f"{old}->{new}"
    if key in _warned:
        return
    _warned.add(key)
    warnings.warn(
        f"{old} is a facade over the unified metrics tree; use {new} "
        f"(docs/profiling.md)", DeprecationWarning, stacklevel=3)
