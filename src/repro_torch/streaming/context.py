"""StreamContext — unbounded source → micro-batch job submissions
(docs/streaming.md, DESIGN.md §12).

One pump (driver thread) per tenant stream:

  poll → admit → submit a micro-batch action on the ``IJob`` scheduler →
  commit results strictly in batch order → checkpoint (offset, batch
  index, operator state) every N commits.

Backpressure is DRIVER-side: the pump bounds its own in-flight futures and
parks on the oldest one (``IFuture.result``) when the admission controller
says ``wait`` — scheduler worker threads are never blocked, so ingestion
pumps, serve ticks and ordinary dataflow jobs keep overlapping in one DAG.

Exactly-once: the source is replayable (``source.py``), the batch function
is deterministic, commits happen in submission order on the pump thread,
and a checkpoint is only cut at a quiesce point (nothing in flight) — so a
killed micro-batch (``stream.batch`` fault → scheduler lineage retry) or a
full restart from ``ckpt_dir`` reconverges to bit-identical operator state,
with the replay count surfaced exactly (``batches_replayed``).
"""
from __future__ import annotations

import os
import time
from collections import deque
from typing import Callable, Optional

import numpy as np

import torch

from repro_torch.core import faults, tree
from repro_torch.core.job import IJob
from repro_torch.core.partition import to_host


def _default_batch_fn(rows: np.ndarray) -> np.ndarray:
    """Deterministic per-batch summary: exact int64 column sums."""
    return np.sum(np.asarray(rows, dtype=np.int64), axis=0)


def _default_fold_fn(state, result):
    return np.asarray(state, dtype=np.int64) + np.asarray(result, dtype=np.int64)


class _Pending:
    __slots__ = ("index", "future", "next_offset", "t_submit")

    def __init__(self, index, future, next_offset, t_submit):
        self.index = index
        self.future = future
        self.next_offset = next_offset
        self.t_submit = t_submit


class StreamContext:
    """Micro-batch pump for ONE tenant stream.

    ``batch_fn(rows) -> result`` runs INSIDE the job task (retried via
    lineage on recoverable failure; must be deterministic);
    ``fold_fn(state, result) -> state`` runs on the pump thread at commit
    time, strictly in batch order. The default pair keeps exact int64
    column sums — bit-identity under replay is checkable with ``==``.
    """

    def __init__(self, worker, source, *, tenant: str = "t0", name: str = "stream",
                 group=None, job: Optional[IJob] = None,
                 batch_fn: Optional[Callable] = None,
                 fold_fn: Optional[Callable] = None,
                 init_state=None, ckpt_dir: Optional[str] = None,
                 admission=None, telemetry=None, props=None):
        from repro_torch.streaming.admission import AdmissionController
        from repro_torch.streaming.telemetry import StreamTelemetry

        self.worker = worker
        self.source = source
        self.tenant = tenant
        self.name = name
        self.group = group
        self.props = props if props is not None else worker.cluster.props
        self.batch_rows = self.props.get_int("ignis.stream.batch.rows", 256)
        self.ckpt_interval = self.props.get_int("ignis.stream.checkpoint.interval", 0)
        self.ckpt_dir = ckpt_dir
        self.job = job if job is not None else IJob(f"{name}:{tenant}")
        self.admission = admission if admission is not None else \
            AdmissionController(self.props)
        self.telemetry = telemetry if telemetry is not None else StreamTelemetry()
        self.telemetry.attach(self.job, self.admission)
        self.batch_fn = batch_fn or _default_batch_fn
        self.fold_fn = fold_fn or _default_fold_fn
        if ckpt_dir is not None and init_state is None:
            raise ValueError(
                "exactly-once restart needs a fixed state structure: pass "
                "init_state (a pytree of numpy arrays) with ckpt_dir")
        self._init_state = init_state
        # commit pointer: offset/batch index/state of the last COMMITTED batch
        self.state = None if init_state is None else _np_copy(init_state)
        self.offset = 0
        self.batch_index = 0  # next batch ordinal to submit
        self.committed = 0    # batches committed (== next commit ordinal)
        self.batches_replayed = 0
        self.shed_batches = 0
        self._pending: deque[_Pending] = deque()
        self._restored_from: Optional[int] = None
        if ckpt_dir is not None:
            self._maybe_restore()

    # ------------------------------------------------------------------
    # checkpoint / restore (exactly-once restart)
    # ------------------------------------------------------------------
    def _ckpt_tree(self):
        return {
            "offset": np.asarray(self.offset, np.int64),
            "committed": np.asarray(self.committed, np.int64),
            "replayed": np.asarray(self.batches_replayed, np.int64),
            "state": self.state,
        }

    def _maybe_restore(self):
        from repro_torch import checkpoint as ck

        step = ck.latest_step(self.ckpt_dir)
        if step is None:
            return
        target = {
            "offset": np.zeros((), np.int64),
            "committed": np.zeros((), np.int64),
            "replayed": np.zeros((), np.int64),
            "state": self._init_state,
        }
        # the pump's state lives on the host: restore it there
        restored = ck.restore(self.ckpt_dir, step, target, "cpu")
        self.offset = int(restored["offset"])
        self.committed = self.batch_index = int(restored["committed"])
        self.batches_replayed = int(restored["replayed"])
        self.state = _np_copy(restored["state"])
        self._restored_from = step

    def _checkpoint(self, crash: bool = False):
        """Cut a checkpoint at a quiesce point: callers drain in-flight
        batches first, so (offset, committed, state) are mutually
        consistent — restoring replays nothing and skips nothing.
        ``crash=True`` skips the quiesce assert: in-order commits keep
        (offset, committed, state) consistent after EVERY commit, so the
        committed prefix is a valid checkpoint even with a failed batch
        still in flight — it will be replayed from the source on restart."""
        from repro_torch import checkpoint as ck

        assert crash or not self._pending, "checkpoint requires a quiesced pump"
        os.makedirs(self.ckpt_dir, exist_ok=True)
        ck.save(self.ckpt_dir, self.committed, self._ckpt_tree(), keep=3)
        # the job memo pinned every evaluated micro-batch subgraph; state is
        # durable now, so release it — the streaming analogue of
        # lineage truncation at a checkpoint (docs/fault_tolerance.md)
        self.job.release()

    def _drain_then_checkpoint(self):
        """Drain to a quiesce point and cut the checkpoint. If a batch
        failure aborts the drain, cut a crash checkpoint of the committed
        prefix BEFORE propagating: without it, a fault landing on a batch
        that was pipelined behind the checkpoint trigger would abort the
        pump with NO checkpoint at all, and the restart would replay the
        whole stream instead of resuming from the last commit (the restart
        stays exactly-once either way — this bounds replay work, and makes
        ``restored_from`` deterministic for the chaos tier)."""
        try:
            self.drain()
        except BaseException:
            try:
                self._checkpoint(crash=True)
            except Exception:
                pass  # best-effort: the original abort must propagate
            raise
        self._checkpoint()

    @property
    def restored_from(self) -> Optional[int]:
        return self._restored_from

    # ------------------------------------------------------------------
    # the pump
    # ------------------------------------------------------------------
    def _submit_batch(self, rows: np.ndarray, next_offset: int):
        index = self.batch_index
        worker, tenant, batch_fn = self.worker, self.tenant, self.batch_fn
        with worker.use_group(self.group):
            # parallelize under the group binding: blocks land on the
            # tenant's rank slice, and the action task below is pinned to
            # the same group — ingestion slices never contend on one lock
            frame = worker.parallelize(rows)
        node = frame.node

        def task_fn(memo, _node=node, _index=index):
            faults.check("stream.batch", tenant=tenant, batch=_index)
            blocks = worker.engine.evaluate(_node, memo=memo)
            out: list = []
            for b in blocks:
                out.extend(to_host(b))
            return batch_fn(np.asarray(out))

        fut = self.job.submit_action(frame, f"{self.name}.{tenant}.b{index}",
                                     task_fn=task_fn, group=self.group)
        self._pending.append(_Pending(index, fut, next_offset, time.perf_counter()))
        self.batch_index += 1
        self.telemetry.record_admitted(tenant)

    def _commit_head(self, block: bool):
        """Commit the oldest in-flight batch (strictly in order). Returns
        True if a batch was committed."""
        if not self._pending:
            return False
        head = self._pending[0]
        if not block and not head.future.done():
            return False
        result = head.future.result()  # propagates non-recoverable errors
        self._pending.popleft()
        task = head.future.task
        replays = task.attempt  # extra scheduler attempts == replays
        self.batches_replayed += replays
        if self.state is None:
            self.state = _np_copy(result)
        else:
            self.state = self.fold_fn(self.state, result)
        self.offset = head.next_offset
        self.committed += 1
        self.admission.release(self.tenant)
        self.telemetry.record_completed(
            self.tenant, (time.perf_counter() - head.t_submit) * 1e3, replays)
        if (self.ckpt_dir is not None and self.ckpt_interval > 0
                and self.committed % self.ckpt_interval == 0):
            self._drain_then_checkpoint()
        return True

    def _commit_ready(self):
        while self._commit_head(block=False):
            pass

    def drain(self):
        """Commit every in-flight batch (driver-side wait)."""
        while self._pending:
            self._commit_head(block=True)

    def run(self, max_batches: Optional[int] = None):
        """Pump until the source is exhausted (or ``max_batches`` more
        batches committed). Returns the folded operator state."""
        target = None if max_batches is None else self.committed + max_batches
        while target is None or self.batch_index < target:
            self._commit_ready()
            decision = self.admission.try_admit(self.tenant)
            if decision == "wait":
                # backpressure: park on OUR oldest future if any, else on
                # the controller (another tenant's commit frees the bound)
                if self._pending:
                    self._commit_head(block=True)
                else:
                    self.admission.wait_for_change()
                continue
            rows, next_offset = self.source.poll(self.offset_next_poll,
                                                 self.batch_rows)
            if rows is None or len(rows) == 0:
                if decision == "admit":  # slot acquired but nothing to run
                    self.admission.release(self.tenant)
                break
            if decision == "shed":
                # explicit load shedding: the batch is dropped and the
                # offset advances past it — visible in telemetry, and only
                # reachable under policy "shed" / injected stream.admit
                # faults (policy "block" never sheds: docs/streaming.md)
                self.shed_batches += 1
                self.telemetry.record_shed(self.tenant)
                self._apply_shed(next_offset)
                continue
            self._submit_batch(rows, next_offset)
        if self.ckpt_dir is not None and self.ckpt_interval > 0:
            self._drain_then_checkpoint()
        else:
            self.drain()
        return self.state

    def _apply_shed(self, next_offset: int):
        """Advance the poll cursor past a shed batch. The COMMIT offset only
        moves once every in-flight batch ahead of the shed point lands, so
        a crash mid-shed replays (rather than loses) trailing batches."""
        self.drain()
        self.offset = next_offset
        self.batch_index += 1  # a shed batch consumes its ordinal: the run
        # budget counts polled batches, so an all-shedding fault plan still
        # terminates

    @property
    def offset_next_poll(self) -> int:
        """Where the next poll starts: the committed offset plus everything
        already in flight."""
        return self._pending[-1].next_offset if self._pending else self.offset

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "tenant": self.tenant,
            "committed": self.committed,
            "offset": self.offset,
            "inflight": len(self._pending),
            "batches_replayed": self.batches_replayed,
            "shed_batches": self.shed_batches,
            "restored_from": self._restored_from,
        }


def _np_copy(state):
    """A host copy of a state tree, every leaf a numpy array."""
    return tree.map(
        lambda x: (x.detach().cpu().numpy().copy() if isinstance(x, torch.Tensor)
                   else np.array(x, copy=True)), state)
