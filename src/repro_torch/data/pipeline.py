"""Data pipeline built ON the dataflow layer — the paper's hybrid pattern
(Fig. 12): Big-Data tasks (tokenize / filter / pack) prepare the data, the
compute-intensive task (the train step) consumes it over the same fabric.

Byte-level tokenizer (no external vocab), document packing into fixed
seq_len rows with next-token labels and a loss mask (PAD positions carry
label -1, which the loss layer ignores — layers._ce_block), double-buffered
host→device feed (the port of ``repro.data.pipeline``: the same rows and
batches from the same seed, bit for bit; the feed stages batches through
pinned memory on a side stream, see ``TrainPipeline``). Packing and
batching surface what they drop (``stats=``): the tail tokens past the
last full row and the partial batch at each epoch end — silent discards
would skew any data-accounting done on top (docs/streaming.md uses the
same accounting discipline for shed micro-batches).
"""
from __future__ import annotations

import threading
from queue import Empty, Full, Queue
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.profile.spans import span

BOS, EOS, PAD = 256, 257, 258
VOCAB = 259  # bytes + specials


def byte_tokenize(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("utf-8", errors="replace"), np.uint8).astype(np.int32)


def pack_sequences(docs, seq_len: int, stats: Optional[dict] = None) -> np.ndarray:
    """Pack tokenized docs (list of int arrays) into (n, seq_len+1) rows
    (the +1 column yields next-token labels).

    Tokens past the last full row are DROPPED (fixed-shape rows); pass a
    ``stats`` dict to receive ``dropped_tail_tokens`` (and ``packed_rows`` /
    ``stream_tokens`` for the denominator) instead of losing that count.
    """
    stream: list[int] = []
    for d in docs:
        stream.append(BOS)
        stream.extend(int(t) for t in d)
        stream.append(EOS)
    L = seq_len + 1
    n = max(len(stream) // L, 1)
    arr = np.full((n, L), PAD, np.int32)
    flat = np.asarray(stream[: n * L], np.int32)
    arr.reshape(-1)[: flat.size] = flat
    if stats is not None:
        stats["stream_tokens"] = len(stream)
        stats["packed_rows"] = n
        stats["dropped_tail_tokens"] = max(len(stream) - n * L, 0)
    return arr


def loss_mask_for(labels: np.ndarray) -> np.ndarray:
    """True where a label is a real next-token target (not PAD filler)."""
    return labels != PAD


def batches_from_rows(rows: np.ndarray, batch: int, *, seed: int = 0,
                      epochs: Optional[int] = None,
                      stats: Optional[dict] = None) -> Iterator[dict]:
    """Yield ``{"tokens", "labels", "loss_mask"}`` host batches forever (or
    for N epochs).

    ``loss_mask`` marks real next-token targets; PAD positions are also
    rewritten to label ``-1`` so the model's cross-entropy (which masks
    negative labels) never trains on padding. Rows that do not fill a batch
    at an epoch end are dropped; a ``stats`` dict receives the running
    ``dropped_partial_rows`` count (and ``epochs_done``) so the discard is
    visible rather than silent.
    """
    rng = np.random.default_rng(seed)
    e = 0
    if stats is not None:
        stats.setdefault("dropped_partial_rows", 0)
        stats.setdefault("epochs_done", 0)
    while epochs is None or e < epochs:
        order = rng.permutation(len(rows))
        n_full = (len(order) // batch) * batch
        for i in range(0, n_full, batch):
            sel = rows[order[i : i + batch]]
            labels = sel[:, 1:]
            mask = loss_mask_for(labels)
            yield {"tokens": sel[:, :-1],
                   "labels": np.where(mask, labels, -1).astype(labels.dtype),
                   "loss_mask": mask}
        e += 1
        if stats is not None:
            stats["dropped_partial_rows"] += len(order) - n_full
            stats["epochs_done"] = e


class TrainPipeline:
    """Double-buffered feed: a background thread stages the next host batch
    on the device while the current step runs (compute/transfer overlap).

    On a CUDA ``device`` the thread copies each array into pinned host
    memory and from there to the device with ``non_blocking=True`` on a
    side stream, and records an event after the copies; ``__next__`` makes
    the consumer's current stream wait on that event before it hands the
    batch out (and marks the tensors as used on that stream, so the
    allocator does not reuse their memory while a step still reads it).
    JAX's ``device_put`` orders the copy before its use by itself; here
    the wait is what keeps a step from reading a batch whose copy has not
    landed. On the CPU a batch is the host arrays as tensors."""

    def __init__(self, batch_iter: Iterator[dict], device="cuda", depth: int = 2):
        self._it = batch_iter
        self._device = torch.device(device)
        self._stream = (torch.cuda.Stream(self._device) if self._device.type == "cuda"
                        else None)
        self._q: Queue = Queue(maxsize=depth)
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _stage(self, hb: dict):
        """``(batch of tensors on the device, event after its copies or
        None)``."""
        arrays = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in hb.items()}
        if self._stream is None:
            return arrays, None
        with torch.cuda.device(self._device), torch.cuda.stream(self._stream):
            out = {k: t.pin_memory().to(self._device, non_blocking=True)
                   for k, t in arrays.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def _enqueue(self, item) -> bool:
        """Bounded put that stays interruptible: a plain ``Queue.put`` on a
        full queue parks forever, so a consumer that stops iterating (or
        calls ``close()``) would leak this thread blocked in ``put`` —
        ``close()`` could then never ``join`` it. Returns False once
        stopped."""
        while not self._stop:
            try:
                self._q.put(item, timeout=0.05)
                return True
            except Full:
                continue
        return False

    def _run(self):
        for hb in self._it:
            if self._stop:
                return
            if not self._enqueue(self._stage(hb)):
                return
        self._enqueue(None)

    def __iter__(self):
        return self

    def __next__(self):
        with span("feed.wait"):
            item = self._q.get()
            if item is None:
                raise StopIteration
            batch, done = item
            if done is not None:
                consumer = torch.cuda.current_stream(self._device)
                consumer.wait_event(done)
                for t in batch.values():
                    t.record_stream(consumer)
        return batch

    def close(self):
        """Stop the producer and reclaim its thread. Safe with a FULL queue
        and a stopped consumer: the stop flag unblocks the producer's
        bounded put, the drain below frees any slot it may still be
        spinning on, and the join confirms the thread exited."""
        self._stop = True
        while True:
            try:
                self._q.get_nowait()
            except Empty:
                break
        self._thread.join(timeout=5.0)
