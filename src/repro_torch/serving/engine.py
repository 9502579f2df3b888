"""Continuous-batching serve engine (the port of ``repro.serving.engine``).

Fixed-slot design: the cache is a (slots, …) slab (KV rows for the
transformers, the O(1) recurrent state for the SSM, both for the hybrid);
new requests are
admitted into free slots via single-row prefill, every engine step runs ONE
batched decode over all live slots, finished requests retire and free their
slot. A request reaching its token budget retires (with a truncation flag
when it has an ``eos_id`` it did not meet).

The slab lives on the model's device and is updated in place: prefill
caches are spliced into their slot, and a transformer's decode writes one
KV row per slot (the SSM's decode returns a new state, as in the JAX
package).

When a decode is graphed: on a CUDA device, once the first decode (run
eagerly and served) has returned every slab leaf but ``pos`` as the very
tensor it was given (``why_not_graphed``), the decode is captured as a
CUDA graph right after it (the model's step, the argmax and the positions'
advance, over the slab and a static token buffer) and replayed from the
next tick on, one replay a tick: the same kernels on the same buffers,
without the host launching them one by one. A decode that returns new
state (the SSM's, the hybrid's), a CPU engine, or a capture that raises (a
host read or a synchronise inside the step) decodes eagerly, and
``decode_graph`` says why. Rebinding the weights, the bundle or a slab
leaf drops the graph: the next decode is tested again, eagerly.

The engine feeds token prompts, as the JAX engine does: the VLM is served
text-only, and the audio family's prefill, which needs ``frames``, raises;
both take their patches or frames through ``bundle.prefill`` itself. Its
``_splice`` writes each cache leaf on that leaf's batch axis — the
hybrid's ``conv``/``state`` are ``(n_blocks, mamba slots, B, …)`` — where the JAX
``_splice`` writes every leaf on axis 1 and so lands a hybrid request's
recurrent state in slot 0.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.profile.spans import settle, span


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (Lp,) int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    # runtime
    tokens: list = field(default_factory=list)
    done: bool = False
    truncated: bool = False
    t_submit: float = 0.0  # perf_counter at ServeEngine.submit


@dataclass
class DecodeGraph:
    """How a ``ServeEngine``'s batched decodes ran: ``captures`` of the
    decode as a CUDA graph, ``replays`` of one, ``eager`` decodes (every
    decode is one or the other; a capture follows an eager one), and
    ``why_eager``, why the engine decodes eagerly (None before the first
    decode and while a graph is captured)."""

    captures: int = 0
    replays: int = 0
    eager: int = 0
    why_eager: Optional[str] = None


def why_not_graphed(device, given: dict, returned: dict) -> Optional[str]:
    """Why a decode step on ``device`` that was given the slab ``given`` and
    returned the cache ``returned`` cannot be replayed from a CUDA graph;
    None where it can: the device is CUDA and the step wrote its cache in
    place, returning every leaf but ``pos`` as the very tensor it was given.
    (A graph replays onto the buffers it was captured with: a step that
    returns new state would leave the slab behind.)"""
    kind = torch.device(device).type
    if kind != "cuda":
        return f"the engine's device is {kind}: decode graphs need CUDA"
    if returned.keys() != given.keys():
        return f"decode_step returned the leaves {sorted(returned)} for {sorted(given)}"
    new = [k for k in given if k != "pos" and returned[k] is not given[k]]
    if new:
        return f"decode_step returns new tensors for {', '.join(new)}: not in place"
    return None


class _Captured:
    """One batched decode captured as a CUDA graph: the static token buffer
    it reads, the next tokens it writes, what it was captured with (checked
    by identity before each replay) and the kernel launches it makes."""

    def __init__(self, engine, graph, tokens, nxt, launches):
        self.graph, self.tokens, self.next, self.launches = graph, tokens, nxt, launches
        self.params, self.bundle, self.cache = engine.params, engine.bundle, dict(engine.cache)

    def bound_to(self, engine) -> bool:
        return (engine.params is self.params and engine.bundle is self.bundle
                and engine.cache.keys() == self.cache.keys()
                and all(engine.cache[k] is t for k, t in self.cache.items()))

    def replay(self, last: np.ndarray) -> torch.Tensor:
        self.tokens.copy_(torch.from_numpy(last)[:, None])
        self.graph.replay()
        kernels.credit_launches(self.launches)
        return self.next


class ServeEngine:
    def __init__(self, bundle, params, *, slots: int = 4, cache_len: int = 256):
        self.bundle = bundle
        self.cfg = bundle.cfg
        self.params = params
        self.device = params.device
        self.slots = slots
        self.cache_len = cache_len
        self.cache = bundle.make_cache(slots, cache_len, device=self.device)
        self.live: list[Optional[Request]] = [None] * slots
        # deque: admission pops from the head every tick
        self.queue: deque[Request] = deque()
        # requests finished but not yet reported: the engine appends here the
        # moment a request retires (whether at prefill or mid-decode) and
        # run_to_completion() drains it — callers polling step() directly can
        # drain it themselves
        self.retired: list[Request] = []
        self._last = np.zeros((slots,), np.int32)
        self.decode_graph = DecodeGraph()
        self._graph: Optional[_Captured] = None
        # whether a decode has been tested for in place (and, if it was,
        # captured) since the engine started or was rebound
        self._tested = False

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def _finish_check(self, req: Request, tok: int) -> bool:
        """Apply the retirement rules to the just-appended token."""
        if req.eos_id is not None and tok == req.eos_id:
            req.done = True
        if len(req.tokens) >= req.max_new_tokens:
            req.done = True
            req.truncated = req.eos_id is not None and tok != req.eos_id
        return req.done

    def _admit(self):
        prefills = 0
        with span("engine.admit") as sp:
            for s in range(self.slots):
                if self.live[s] is not None:
                    continue
                while self.queue:
                    req = self.queue.popleft()
                    self._prefill_into_slot(s, req)
                    prefills += 1
                    # the prefill already produced a token: a request done at
                    # its first token retires without ever occupying the slot
                    if self._finish_check(req, req.tokens[-1]):
                        self.retired.append(req)
                        continue  # slot still free: admit the next waiter
                    self.live[s] = req
                    break
            if sp:
                sp.args["prefills"] = prefills

    def _prefill_into_slot(self, s: int, req: Request):
        """Single-request prefill, then splice its cache rows into slot s.
        Its program span's ``launch`` ends when the bundle's prefill
        returns, ``readback`` is the host waiting for the first token."""
        with span("engine.prefill") as sp:
            if sp:
                sp.args.update(rid=req.rid, tokens=len(req.prompt),
                               queue_ms=(sp.t0 - req.t_submit) * 1e3)
            with span("launch"):
                tokens = torch.as_tensor(np.asarray(req.prompt, np.int32),
                                         device=self.device)[None]
                logits, cache1 = self.bundle.prefill(self.params, tokens=tokens)
            with span("readback"):
                first = int(torch.argmax(logits[0]))
            if sp:
                settle()  # the spans' device counts, now that the device has caught up
            req.tokens.append(first)
            self._last[s] = first
            with span("splice"):
                _splice(self.cache, cache1, s, self.cache_len)

    # ------------------------------------------------------------------
    def step(self) -> int:
        """Admit + one batched decode tick. Returns #live requests. Its
        program span's decode ``launch`` ends when ``decode_step`` returns
        (or the graph's replay is enqueued), ``readback`` is the host
        waiting for the next tokens; ``graph`` says how the decode ran:
        ``"eager"``, ``"capture"`` (eagerly, then captured) or
        ``"replay"``."""
        with span("engine.step") as sp:
            if sp:
                sp.args.update(live=sum(r is not None for r in self.live),
                               queue=len(self.queue))
            self._admit()
            if not any(r is not None for r in self.live):
                return 0
            with span("engine.decode") as dp:
                if dp:
                    dp.args["live"] = sum(r is not None for r in self.live)
                with span("launch"):
                    how, out = self._decode()
                with span("readback"):
                    if how != "replay":
                        out = torch.argmax(out, dim=-1).to(torch.int32)
                    nxt = out.cpu().numpy()
                if dp:
                    dp.args["graph"] = how
                    settle()
            for s, req in enumerate(self.live):
                if req is None:
                    continue
                tok = int(nxt[s])
                req.tokens.append(tok)
                self._last[s] = tok
                if self._finish_check(req, tok):
                    self.retired.append(req)
                    self.live[s] = None  # slot freed; stale cache rows are
                    # harmless: admission overwrites them via _splice
            return sum(r is not None for r in self.live)

    def _decode(self) -> tuple[str, torch.Tensor]:
        """Enqueue the tick's batched decode over every slot: ``("replay",
        next tokens)`` from the graph, else ``("eager", logits)``, or
        ``("capture", logits)`` where this eager decode, the first since the
        engine started or was rebound, proved in place and the decode was
        then captured. The capture follows it on the same thread because
        the eager decode creates the thread's library handles (cuBLAS),
        which a capture cannot; the front door ticks on any of the
        scheduler's threads."""
        rec = self.decode_graph
        if self._graph is not None and not self._graph.bound_to(self):
            self._graph, self._tested = None, False  # rebound: test again
        if self._graph is not None:
            rec.replays += 1
            return "replay", self._graph.replay(self._last)
        given = self.cache
        toks = torch.as_tensor(self._last, device=self.device)[:, None]
        logits, self.cache = self.bundle.decode_step(self.params, given, toks)
        rec.eager += 1
        if self._tested:
            return "eager", logits
        self._tested = True
        rec.why_eager = why_not_graphed(self.device, given, self.cache)
        if rec.why_eager is None:
            self._graph = self._capture()
        return ("eager" if self._graph is None else "capture"), logits

    def _capture(self) -> Optional[_Captured]:
        """Capture the decode of the slab as it stands on a side stream. The
        capture runs nothing (the eager decode served this tick; the graph
        serves the next). The positions advance inside the graph, into
        ``cache["pos"]`` itself, which ``_splice`` keeps writing. None, and
        eager decodes from here on, where the capture raises (a synchronise
        or a host read inside the step) or the step turns out not in place."""
        tokens = torch.zeros((self.slots, 1), dtype=torch.int32, device=self.device)
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(self.device)
        cache = self.cache
        why = None
        # the capture's launches run at each replay: counted there
        with kernels.uncounted() as launches:
            try:
                # the outer context restores the thread's stream where the
                # graph's own exit raises before it does (entering, the
                # graph synchronises the device)
                with torch.cuda.stream(stream), torch.cuda.graph(
                        graph, stream=stream, capture_error_mode="thread_local"):
                    logits, out = self.bundle.decode_step(self.params, cache, tokens)
                    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
                    cache["pos"].copy_(out["pos"])
            except RuntimeError as e:
                while e.__context__ is not None:  # the error that broke the capture
                    e = e.__context__
                first = str(e).strip().partition("\n")[0]
                why = f"the capture raised {type(e).__name__}: {first}"
        why = why or why_not_graphed(self.device, cache, out)
        if why is not None:
            self.decode_graph.why_eager = why
            return None
        self.decode_graph.captures += 1
        return _Captured(self, graph, tokens, nxt, launches)

    def run_to_completion(self, max_ticks: int = 10_000) -> list[Request]:
        """Tick until queue and slots drain; returns (and clears) the
        retired list, which ``step()`` itself records."""
        ticks = 0
        while (self.queue or any(r is not None for r in self.live)) \
                and ticks < max_ticks:
            self.step()
            ticks += 1
        out, self.retired = self.retired, []
        return out


def _batch_axis(name, slab, single, slots: int, cache_len: int) -> int:
    """The axis of cache leaf ``name`` that indexes the slots: the one axis
    where the slab has ``slots`` entries and the request's cache 1, with
    every other axis equal but, for a KV leaf, the one right after it (the
    slab's ``cache_len`` positions against the request's Lp). Raises where
    the shapes name no such axis or more than one."""
    found = []
    for a in range(slab.ndim if slab.ndim == single.ndim else 0):
        if slab.shape[a] != slots or single.shape[a] != 1:
            continue
        differ = [i for i in range(slab.ndim) if i != a and slab.shape[i] != single.shape[i]]
        if not differ or (differ == [a + 1] and slab.shape[a + 1] == cache_len):
            found.append(a)
    if len(found) != 1:
        raise ValueError(f"cache leaf {name!r}: request {tuple(single.shape)} against the slab "
                         f"{tuple(slab.shape)} of {slots} slots names "
                         f"{'no' if not found else 'more than one'} batch axis")
    return found[0]


def _splice(cache, cache1, slot: int, cache_len: int):
    """Write a request cache (batch 1) into slot ``slot`` of the slab (batch
    ``slots``, the length of ``pos``), in place, casting to the slab's dtype
    (bf16 even for an f32 model). Returns the slab.

    Each leaf is written on its batch axis (``_batch_axis``): axis 0 of
    ``pos``, axis 1 of the per-layer stacks ``(L, B, …)``, axis 2 of the
    hybrid's mixer state ``(n_blocks, mamba slots, B, …)``. A KV leaf (``(L, B,
    cache_len, …)`` against the request's ``(L, 1, Lp, …)``) takes the
    request's Lp rows and is zeroed beyond them, as the JAX package pads
    with zeros; a state-like leaf (a conv tail, an SSM state) has the same
    shape in both and is copied whole into its slot."""
    slots = cache["pos"].shape[0]
    for name, slab in cache.items():
        single = cache1[name]
        if slots == 1 and slab.shape == single.shape:
            slab.copy_(single)
            continue
        a = _batch_axis(name, slab, single, slots, cache_len)
        dst, src = slab.select(a, slot), single.select(a, 0)
        if dst.shape == src.shape:
            dst.copy_(src)
            continue
        Lp = src.shape[a]  # the KV leaf's length axis, now at a
        if Lp > cache_len:
            raise ValueError(f"prompt cache of {Lp} positions exceeds cache_len {cache_len}")
        dst.narrow(a, 0, Lp).copy_(src)
        dst.narrow(a, Lp, cache_len - Lp).zero_()
    return cache
