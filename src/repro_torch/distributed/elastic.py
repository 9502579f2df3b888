"""Elastic mesh — runtime grow/shrink of executor ranks (docs/elasticity.md,
DESIGN.md §14).

* **Runtime elasticity**: the incremental reshard that backs
  ``IWorker.grow``/``IWorker.shrink`` (core/cluster.py). ``plan_reshard``
  is the pure move/keep rule; ``reshard_cached`` walks the worker's cached
  nodes and MOVES only the blocks whose ownership changed — never a full
  lineage recompute. A block lost mid-move (the ``elastic.reshard`` fault
  site) degrades to a lineage hole repaired block-wise on the next action.

* **Autoscaling**: ``ElasticPolicy`` — scheduler queue depth and tenant
  admissions (streaming/frontend.py) drive deterministic grow/shrink
  decisions off the ``ignis.elastic.*`` properties.

* **Checkpoint elasticity** (``restore_elastic``): re-places a saved
  train-state tree onto a differently-shaped mesh. Checkpoints store full
  logical arrays, so elasticity is a placement decision at restore: derive
  the specs from the same rules (``distributed/sharding.py``), restore on
  the mesh's device, place. Divisibility permitting, any (pod, data, model)
  factorisation restores the same training state.

Ranks are virtual executor slots on one device (``ICluster.slots``): a
block's "devices" are the world ranks it is committed to (``block_ranks``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.checkpoint.checkpoint import restore
from repro_torch.core import faults, tree
from repro_torch.core.metrics import Counters
from repro_torch.core.partition import Block, block_ranks, pad_to, place_block
from repro_torch.distributed import sharding


class PlacedState(dict):
    """A restored train-state tree (``{"params"[, "opt"]}``, leaves on the
    mesh's device) and, in ``placement``, the same keys' trees of
    ``sharding.Placement``: which rank of ``mesh`` holds which slice."""

    def __init__(self, state: dict, placement: dict, mesh):
        super().__init__(state)
        self.placement = placement
        self.mesh = mesh


def restore_elastic(ckpt_dir: str, step: int, cfg, mesh, target: dict) -> PlacedState:
    """Restore a train-state tree ``{"params": …[, "opt": …]}`` re-placed
    for ``mesh`` (``launch.mesh.Mesh``; it may have another shape than the
    one that saved). ``target`` holds the JAX package's trees, as
    ``launch.train.checkpoint_tree`` gives them (tensors, ``meta`` tensors or
    anything with a ``shape``; ``params`` may be the port's model). A leaf
    whose shape disagrees with the checkpoint raises ``ValueError``."""
    target = {**target, "params": sharding.param_tree(target["params"])}
    psp = sharding.param_specs(target["params"], cfg, mesh)
    specs = {"params": psp}
    if "opt" in target:
        specs["opt"] = sharding.opt_specs(target["opt"], psp, cfg, mesh)
    state = restore(ckpt_dir, step, target, mesh.device)
    placement = {k: sharding.to_named(s, mesh, state[k]) for k, s in specs.items()}
    return PlacedState(state, placement, mesh)


# ---------------------------------------------------------------------------
# incremental reshard: the move/keep rule and the block mover
# ---------------------------------------------------------------------------

def plan_reshard(ranks: Optional[frozenset], old_world: frozenset,
                 new_world: frozenset) -> str:
    """Pure move/keep decision for one cached block across a resize.

    ``ranks`` is the block's committed rank set (``block_ranks``; None =
    host/uncommitted). A block moves when its ownership changed: it touches
    a retired rank, it was bound to the FULL old world (world partitions
    re-spread over the resized world — capacity must become a multiple of
    the new executor count before any wide stage runs), or it is not fully
    contained in the new world. A block resident wholly on a surviving
    sub-group keeps its placement: if a later task binds it to a different
    communicator, the lazy ingress reshard (shuffle ``_placed``) handles it
    then.
    """
    if ranks is None:
        return "move"
    retired = old_world - new_world
    if ranks & retired:
        return "move"
    if ranks == old_world:
        return "move"
    if not ranks <= new_world:
        return "move"
    return "keep"


def repad_block(block: Block, p: int, ctx) -> Block:
    """Re-pad a Block's capacity to a multiple of ``p`` (zero data, False
    validity) and commit it to communicator ``ctx`` — pure data movement,
    no lineage evaluation. Rows stay where they were: appended padding
    leaves each rank's rows contiguous under the new ``p``, as the
    reference's rows-over-axis placement of the padded array does."""
    cap = block.capacity
    cap2 = max(pad_to(cap, p), p)
    if cap2 != cap:
        pad = cap2 - cap

        def padleaf(x):
            return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])

        block = Block(tree.map(padleaf, block.data), padleaf(block.valid),
                      block.ranks)
    return place_block(block, ctx)


def reshard_cached(worker, old_world: frozenset, new_ctx) -> tuple[int, int, int]:
    """Move the cached blocks whose ownership changed onto ``new_ctx``;
    keep the rest in place. Returns ``(moves, unchanged, recomputes)`` where
    ``recomputes`` counts blocks LOST mid-move (``elastic.reshard`` fault
    site): they are left as lineage holes for block-wise repair — the only
    path by which a resize ever causes recomputation."""
    moves = kept = recomputes = 0
    p = new_ctx.executors
    new_world = frozenset(new_ctx.ranks)
    for node in list(worker._cached_nodes):
        blocks = node.result
        if blocks is None:
            continue
        for i, b in enumerate(blocks):
            if b is None:
                continue  # a pre-existing hole: lineage repair owns it
            if plan_reshard(block_ranks(b), old_world, new_world) == "keep":
                kept += 1
                continue
            try:
                faults.check("elastic.reshard", op=node.op, block=i)
                blocks[i] = repad_block(b, p, new_ctx)
                moves += 1
            except faults.FaultInjected:
                # block lost in flight: hole now, block-wise repair later
                blocks[i] = None
                recomputes += 1
    return moves, kept, recomputes


# ---------------------------------------------------------------------------
# scheduler-driven autoscaling
# ---------------------------------------------------------------------------

class ElasticPolicy:
    """Deterministic autoscaler over ``ignis.elastic.*`` (docs/elasticity.md).

    Two triggers feed it: ``poll()`` reads the job scheduler's queue depth
    (``JobScheduler.queue_depth``) and moves the world toward
    ``ceil(queue / queue.per.executor)``, at most ``step`` ranks per
    decision, after ``cooldown.polls`` consecutive same-direction polls
    (hysteresis is poll-counted, never wall-clock — replayable in tests);
    ``on_admit(tenants)`` (streaming/frontend.py) grows immediately to at
    least one executor per admitted tenant. Both clamp to
    ``[min.executors, max.executors]`` (max 0: every rank slot of the
    cluster) and, unless ``ignis.elastic.enabled``, only RECORD the decision
    (``stats['denied']``) without resizing.
    """

    def __init__(self, worker, scheduler=None, props=None):
        self.worker = worker
        self._scheduler = scheduler
        p = props if props is not None else worker.cluster.props
        self.enabled = p.get_bool("ignis.elastic.enabled", False)
        self.min = max(1, p.get_int("ignis.elastic.min.executors", 1))
        mx = p.get_int("ignis.elastic.max.executors", 0)
        self.max = mx if mx > 0 else worker.cluster.slots
        self.max = max(self.max, self.min)
        self.step = max(1, p.get_int("ignis.elastic.step", 1))
        self.queue_per = max(1, p.get_int("ignis.elastic.queue.per.executor", 4))
        self.cooldown = max(1, p.get_int("ignis.elastic.cooldown.polls", 1))
        self._dir = 0
        self._streak = 0
        self.stats = Counters("policy", {
            "polls": 0,           # poll() calls observed
            "grows": 0,           # grow decisions executed
            "shrinks": 0,         # shrink decisions executed
            "admit_grows": 0,     # grows triggered by tenant admission
            "denied": 0,          # decisions suppressed (enabled=false)
            "ranks_added": 0,
            "ranks_retired": 0,
        })

    # -- pure decision surface ------------------------------------------------
    def desired(self, queue_depth: int) -> int:
        """The world size this queue depth asks for, clamped to [min, max]."""
        want = math.ceil(max(0, queue_depth) / self.queue_per)
        return max(self.min, min(self.max, want))

    def scheduler(self):
        if self._scheduler is None:
            from repro_torch.core.job import default_scheduler

            self._scheduler = default_scheduler()
        return self._scheduler

    # -- triggers ------------------------------------------------------------
    def poll(self, queue_depth: Optional[int] = None) -> int:
        """One autoscaling observation. Returns the executed delta in ranks
        (0 when holding steady, cooling down, or disabled)."""
        if queue_depth is None:
            queue_depth = self.scheduler().queue_depth()
        self.stats["polls"] += 1
        p = self.worker.executors
        want = self.desired(queue_depth)
        direction = (want > p) - (want < p)
        if direction != self._dir:
            self._dir, self._streak = direction, 0
        self._streak += 1
        if direction == 0 or self._streak < self.cooldown:
            return 0
        self._streak = 0  # act, then demand a fresh streak
        delta = max(-self.step, min(self.step, want - p))
        return self._execute(delta)

    def on_admit(self, tenants: int) -> int:
        """Tenant admitted: grow to ≥ one executor per tenant, immediately
        (no cooldown). Returns the executed delta in ranks."""
        p = self.worker.executors
        target = max(self.min, min(self.max, tenants))
        if target <= p:
            return 0
        grown = self._execute(target - p)
        if grown:
            self.stats["admit_grows"] += 1
        return grown

    def _execute(self, delta: int) -> int:
        if delta == 0:
            return 0
        if not self.enabled:
            self.stats["denied"] += 1
            return 0
        if delta > 0:
            self.worker.grow(delta)
            self.stats["grows"] += 1
            self.stats["ranks_added"] += delta
        else:
            self.worker.shrink(-delta)
            self.stats["shrinks"] += 1
            self.stats["ranks_retired"] += -delta
        return delta

    # -- checkpoint elasticity ------------------------------------------------
    def restore(self, ckpt_dir: str, step: int, cfg, target: dict) -> PlacedState:
        """Re-place checkpointed train state onto the worker's CURRENT
        (possibly just-resized) world — ``restore_elastic`` on the one-axis
        mesh of ``worker.context``, so a grow/shrink is followed by one call
        here."""
        from repro_torch.launch.mesh import Mesh

        return restore_elastic(ckpt_dir, step, cfg, Mesh.of_context(self.worker.context),
                               target)
