"""IContext — the executor context (paper §3.6).

The torch analogue of IgnisHPC's MPI communicators (paper Fig. 4). Executors
are ``p`` virtual ranks on one torch device:

  base communicator    → ranks ``0 … p-1`` of the worker's device; a block's
                         flat ``(N, …)`` leaves are read as ``(p, N/p, …)``
  driver communicator  → host↔device copies (``tensor.to(device)``)
  inter-worker comm.   → moving blocks between two workers' devices
  group communicator   → ``split``/``group`` (``MPI_Comm_split`` /
                         ``MPI_Comm_create``): a subset of the ranks with
                         its own collective axis — a collective on the group
                         takes only the group's rows

Inside a native SPMD program the context is what ``MPI_COMM_WORLD`` is to an
MPI code: ``ctx.executors`` is the rank count every collective batches over,
and ``ctx.var(...)`` carries driver variables to the executors.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch


class IContext:
    def __init__(self, ranks, device="cpu", axis: str = "data", props=None,
                 worker=None):
        self.ranks: tuple[int, ...] = (
            tuple(range(ranks)) if isinstance(ranks, int) else tuple(ranks))
        self.device = torch.device(device)
        self.axis = axis
        self.props = props
        self.worker = worker
        self._vars: dict[str, Any] = {}
        # communicator-group lineage (None / () for the base communicator)
        self.parent: "IContext | None" = None
        self.group_ranks: tuple[int, ...] = ()

    # ---- communicator surface (the MPI_COMM_WORLD analogue) ---------------
    def comm(self):
        """The base communicator: (rank tuple, collective axis name)."""
        return self.ranks, self.axis

    @property
    def key(self) -> tuple:
        """Hashable communicator identity for plan caches: two contexts over
        the same ranks of the same device share compiled plans."""
        return (str(self.device), self.ranks, self.axis)

    @property
    def executors(self) -> int:
        """World size along the collective axis."""
        return len(self.ranks)

    def rank(self) -> torch.Tensor:
        """Every executor's rank, one entry per rank of the batched axis."""
        return torch.arange(self.executors, device=self.device)

    def place(self, x):
        """Commit ``x`` to THIS communicator's device (no-op when resident)."""
        return x.to(self.device)

    # ---- communicator groups (MPI_Comm_split / MPI_Comm_create) -----------
    @property
    def is_group(self) -> bool:
        return self.parent is not None

    def label(self) -> str:
        """Human-readable communicator name for explain()/locks."""
        if not self.is_group:
            return self.axis
        lo, hi = self.group_ranks[0], self.group_ranks[-1]
        return f"{self.parent.label()}[{lo}:{hi + 1}]"

    def group(self, ranks: Sequence[int]) -> "IContext":
        """``MPI_Comm_create``: a sub-communicator over ``ranks`` of THIS
        communicator. Collectives issued through it span only those ranks.
        Driver vars are inherited (snapshot)."""
        p = self.executors
        ranks = tuple(int(r) for r in ranks)
        if not ranks:
            raise ValueError("group() needs at least one rank")
        if len(set(ranks)) != len(ranks):
            raise ValueError(f"group() ranks must be distinct, got {ranks}")
        bad = [r for r in ranks if not 0 <= r < p]
        if bad:
            raise ValueError(
                f"group() ranks {bad} out of range for {p} executors")
        # executor blacklist: a base-communicator group must not be built over
        # a lost container — new sub-clusters route around blacklisted ranks
        # until the worker restore_executor()s them. Nested groups use
        # parent-relative ranks, so the guard applies at the base only.
        if self.parent is None and self.worker is not None:
            lost = sorted(
                r for r in ranks
                if r in getattr(self.worker, "executor_blacklist", ()))
            if lost:
                raise ValueError(
                    f"group() ranks {lost} are blacklisted (lost executors); "
                    f"restore_executor() to re-admit them")
        sub = IContext(tuple(self.ranks[r] for r in ranks), self.device,
                       self.axis, self.props, self.worker)
        sub._vars = dict(self._vars)
        sub.parent = self
        sub.group_ranks = ranks
        return sub

    def split(self, n_groups: int) -> "list[IContext]":
        """``MPI_Comm_split`` with ``color = rank // (p / n_groups)``: carve
        the communicator into ``n_groups`` contiguous equal groups. Rejects
        uneven splits — capacity padding and PSRS bucketing both assume every
        group member holds the same row count."""
        p = self.executors
        if n_groups < 1:
            raise ValueError(f"split() needs n_groups >= 1, got {n_groups}")
        if p % n_groups:
            raise ValueError(
                f"split({n_groups}) does not divide {p} executors evenly; "
                f"use group(ranks) for ragged sub-communicators")
        k = p // n_groups
        return [self.group(range(i * k, (i + 1) * k)) for i in range(n_groups)]

    # ---- driver↔executor variable exchange (ISource.addParam / context.var)
    def set_var(self, name: str, value):
        self._vars[name] = value

    def is_var(self, name: str) -> bool:
        return name in self._vars

    def var(self, name: str, default=None):
        return self._vars.get(name, default)

    def vars(self) -> dict:
        return dict(self._vars)

    def child(self, **extra_vars) -> "IContext":
        c = IContext(self.ranks, self.device, self.axis, self.props, self.worker)
        c._vars = {**self._vars, **extra_vars}
        c.parent = self.parent  # a child of a group stays in the group
        c.group_ranks = self.group_ranks
        return c

    def bind(self, params: dict) -> "IContext":
        """Execution-time context for a native task: a child communicator
        carrying the driver's *current* vars plus the call's params (paper
        Fig. 11 ``addParam``), bound when the task RUNS."""
        return self.child(**params)
