"""Meshes of virtual ranks (the port of ``repro.launch.mesh``).

A JAX mesh names the axes of a device array. Here the ranks are virtual
executor ranks on one torch device, as everywhere in the port: a ``Mesh``
names its axes, their sizes and the device, and numbers its ranks
row-major over the axes (the order of a JAX mesh's ``devices.flat``). The
sharding rules (``distributed/sharding.py``) read ``axis_names`` and
``shape``; the expert-parallel MoE and the pipeline schedule run their
exchanges through the communicator of one axis (``Mesh.comm``), the
port's MPI layer (``core/comm``).

``use_mesh`` installs an ambient mesh, the counterpart of the JAX
package's ``compat.set_mesh``/``get_ambient_mesh``. It is thread-local:
the port's ``IJob`` runs tasks of disjoint sub-meshes on threads at once.

Factories are functions, not module constants, and each takes ``device``
(``cuda`` unless the caller asks for the CPU).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch


class Mesh:
    """``shape`` ranks named by ``axis_names`` on ``device``. ``shape`` is
    a name → size dict in axis order; rank ``r``'s coordinates are ``r``
    read row-major over the axes."""

    def __init__(self, shape, axis_names, device="cuda"):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not name its axes {axis_names} "
                             f"once each")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh shape {shape} has an empty axis")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.device = torch.device(device)

    @property
    def size(self) -> int:
        """The rank count."""
        return math.prod(self.shape.values())

    def coords(self, rank: int) -> dict:
        """``{axis: index}`` of ``rank``."""
        out = {}
        for name in reversed(self.axis_names):
            rank, out[name] = divmod(rank, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    def rank_of(self, coords: dict) -> int:
        """The rank at ``coords`` (an axis left out is at index 0)."""
        r = 0
        for name in self.axis_names:
            r = r * self.shape[name] + int(coords.get(name, 0))
        return r

    def comm(self, axis: str):
        """The communicator (``IContext``) over ``axis``'s ranks, the other
        axes at index 0: its collectives (``core/comm``) batch over the
        ranks of that axis."""
        from repro_torch.core.context import IContext

        if axis not in self.shape:
            raise ValueError(f"mesh axes {self.axis_names} have no {axis!r}")
        ranks = tuple(self.rank_of({axis: i}) for i in range(self.shape[axis]))
        return IContext(ranks, self.device, axis)

    @classmethod
    def of_context(cls, ctx) -> "Mesh":
        """The one-axis mesh of a communicator's world (a worker's
        ``context``), as the JAX worker's mesh is ``(p,)`` over
        ``("data",)``."""
        return cls((ctx.executors,), (ctx.axis,), ctx.device)

    def __eq__(self, other):
        return (isinstance(other, Mesh) and self.shape == other.shape
                and self.axis_names == other.axis_names and self.device == other.device)

    def __repr__(self):
        axes = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"Mesh({axes}; {self.device})"


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """16×16 = 256 ranks a pod; multi-pod adds a leading 2-pod axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device)


def make_local_mesh(data: int = 1, model: int = 1, device="cuda") -> Mesh:
    """A small ``(data, model)`` mesh (tests, examples, the smoke run)."""
    return Mesh((data, model), ("data", "model"), device)


def make_pp_mesh(stages: int, data: int = 1, device="cuda") -> Mesh:
    """Pipeline-parallel mesh (stage axis first) for distributed/pipeline.py."""
    return Mesh((stages, data), ("stage", "data"), device)


# ---------------------------------------------------------------------------
# the ambient mesh (thread-local)
# ---------------------------------------------------------------------------

_ambient = threading.local()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Install ``mesh`` as this thread's ambient mesh inside the block
    (``None`` clears it); the previous one comes back on exit."""
    stack = getattr(_ambient, "stack", None)
    if stack is None:
        stack = _ambient.stack = []
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def ambient_mesh() -> Optional[Mesh]:
    """This thread's ambient mesh, or None."""
    stack = getattr(_ambient, "stack", None)
    return stack[-1] if stack else None
