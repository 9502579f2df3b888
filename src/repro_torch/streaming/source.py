"""Stream sources — replayable unbounded inputs (docs/streaming.md).

The exactly-once contract lives HERE: ``poll(offset, max_rows)`` must be a
pure function of its arguments — polling the same offset twice (a replayed
micro-batch after a kill, or a restart from a checkpointed offset) returns
bit-identical rows. Everything downstream (deterministic batch functions,
in-order commits, offset checkpoints) builds on that property.
"""
from __future__ import annotations

import threading
from typing import Callable, Iterator, Optional, Protocol, Tuple

import numpy as np


class StreamSource(Protocol):
    def poll(self, offset: int, max_rows: int) -> Tuple[Optional[np.ndarray], int]:
        """Up to ``max_rows`` rows starting at ``offset``; returns
        ``(rows, next_offset)``. ``rows is None`` (or empty) means the
        source is exhausted at ``offset`` — an unbounded source never is.
        MUST be deterministic in ``(offset, max_rows)``."""
        ...


class ArraySource:
    """A bounded in-memory source: offsets are row indices into one array."""

    def __init__(self, rows: np.ndarray):
        self.rows = np.asarray(rows)

    def poll(self, offset: int, max_rows: int):
        if offset >= len(self.rows):
            return None, offset
        chunk = self.rows[offset : offset + max_rows]
        return chunk, offset + len(chunk)


class IteratorSource:
    """Adapter for iterator-shaped inputs (a data pipeline's generators). Replay works by RECONSTRUCTION: ``factory()`` must return a
    fresh, deterministic iterator of row-arrays, and a poll at an offset
    behind the cursor rebuilds the iterator and skips forward — so a
    replayed batch sees the same rows without the source buffering its whole
    history. Offsets count ROWS, not iterator items; items are concatenated
    and re-chunked to ``max_rows``."""

    def __init__(self, factory: Callable[[], Iterator[np.ndarray]]):
        self.factory = factory
        self._lock = threading.Lock()
        self._it: Optional[Iterator[np.ndarray]] = None
        self._pos = 0  # row offset of the iterator cursor
        self._buf: Optional[np.ndarray] = None  # rows read but not consumed

    def _reset(self):
        self._it = iter(self.factory())
        self._pos = 0
        self._buf = None

    def poll(self, offset: int, max_rows: int):
        with self._lock:
            if self._it is None or offset < self._pos:
                self._reset()
            # skip forward to ``offset`` (drops rows a committed batch
            # already consumed), then accumulate up to max_rows
            out: list[np.ndarray] = []
            have = 0
            while True:
                if self._buf is not None and len(self._buf):
                    chunk = self._buf
                    self._buf = None
                else:
                    try:
                        chunk = np.atleast_1d(np.asarray(next(self._it)))
                    except StopIteration:
                        break
                if self._pos + len(chunk) <= offset:  # entirely pre-offset
                    self._pos += len(chunk)
                    continue
                if self._pos < offset:  # straddles the offset
                    chunk = chunk[offset - self._pos :]
                    self._pos = offset
                take = min(len(chunk), max_rows - have)
                out.append(chunk[:take])
                if take < len(chunk):
                    self._buf = chunk[take:]
                self._pos += take
                have += take
                if have >= max_rows:
                    break
            if not out:
                return None, offset
            rows = np.concatenate(out) if len(out) > 1 else out[0]
            return rows, offset + len(rows)


class TenantRequestSource:
    """Synthetic unbounded per-tenant request stream. Row ``i`` is computed
    ARITHMETICALLY from ``(seed, tenant_id, i)`` — no RNG state, no history
    — so a replay at any batch boundary, or a restart from any checkpointed
    offset, reproduces the exact same rows. Rows are ``(global_index,
    payload)`` int32 pairs; ``limit`` bounds the stream for tests/benches
    (None → unbounded)."""

    _A, _B, _C, _M = 2654435761, 40503, 97, 10_000  # mix constants

    def __init__(self, tenant_id: int, seed: int = 0, limit: Optional[int] = None):
        self.tenant_id = int(tenant_id)
        self.seed = int(seed)
        self.limit = limit

    def poll(self, offset: int, max_rows: int):
        end = offset + max_rows
        if self.limit is not None:
            end = min(end, self.limit)
        if end <= offset:
            return None, offset
        idx = np.arange(offset, end, dtype=np.int64)
        mixed = (idx * self._A + self.tenant_id * self._B + self.seed * self._C)
        payload = (mixed % self._M).astype(np.int32)
        rows = np.stack([idx.astype(np.int32), payload], axis=1)
        return rows, int(end)
