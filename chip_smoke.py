#!/usr/bin/env python3
"""Smoke run of the torch port (``src/repro_torch``) on one NVIDIA card.

Drives the port's main paths through the entry points a user calls — the
paper's hybrid wordcount on ``p = 8`` virtual executor ranks (and the
profile package on its frames), the paper's evaluation apps in ignis and
spark mode, the recovery tier (checkpoints, chaos, the elastic mesh,
streaming ingestion), then seven models of three families served through
``ServeFrontDoor`` (Qwen3-14B, Mamba2-780M, Mixtral-8x7B, OLMo-1B, Yi-9B,
Gemma3-4B, Phi-3.5-MoE), then the other three families (Jamba-1.5-Large,
InternVL2-1B, Whisper-tiny), then the training path (the paper's hybrid
training app, and OLMo-1B, Mamba2-780M, Mixtral-8x7B, InternVL2-1B,
Whisper-tiny and Jamba's gradient at full width), then the rest of
``distributed/`` on meshes of virtual ranks (expert-parallel Phi-3.5-MoE,
OLMo-1B as pipeline stages, ``restore_elastic`` of its train state), then
``launch/``'s last two entry points (the dry run of every assigned cell,
checked against OLMo-1B run on the card, and ``ignis-submit``) — holds
every hand-written kernel against its plain torch version at the
shapes those paths gave it, and reports. Run from the repository root:

    PYTHONPATH=src python3 chip_smoke.py          # N = 2^26 words, p = 8

Each kernel's edge shapes (ragged lengths, every instance, both routes,
ties and non-finite inputs, launches back to back) are held by the tests
marked ``cuda``: ``PYTHONPATH=src python3 -m pytest -q -m cuda tests/``
(``-k <kernel>`` for one kernel), which take this file's tolerances where
both hold a kernel.

Phases, all of them on every run (each prints its lines; any failure exits
non-zero):

1. build   — one ``nvcc`` per CUDA source (flash attention, decode
             attention, SSD scan, MoE router, the segmented and prefix
             scans, bucket router;
             ``sm_90a``, into ``build/kernels/cuda``, where the port's
             loader finds them), all started at once; then the registry's
             capability probes, each kernel's first launch (flash on both
             routes), ptxas' register and spill lines, and each kernel's
             count of tensor-core instructions (``HGMMA``: wgmma, ``HMMA``:
             mma.sync) in its SASS where the toolkit has ``cuobjdump``;
2. hybrid  — the hybrid job, twice with ``ignis.kernels=auto`` (launch
             counters reset before each run) and once with ``off``: branch A
             ``map → reduceByKey(add)`` and ``reduceByKey(max)`` (PSRS sort
             stages whose post hook runs the segment and prefix kernels; the
             max is over a random int32 mark per word),
             branch B ``compact → join`` against a 2^20-row dimension table
             (a hash exchange on both sides: the bucket-route kernel), branch
             C the native ``wordcount`` app; A and C (and B) are submitted
             into one IJob. Checks: word counts equal ``np.bincount``, the
             per-word maxima equal a numpy oracle, every collected frame of
             the kernel runs equals the ``off`` run bit for bit and row for
             row in the order it came back, no fallback, no overflow retry
             and no new wide plan on the second run, every
             ``segment_totals`` call on the path launching the CUDA
             segmented scan and prefix scan once, every kernel-routed
             exchange the CUDA bucket router, and no Triton module left in
             the port. Each run also reports
             the wall time spent in ``to_host`` (the driver-side conversion
             of collected blocks to row trees) and in autotune sweeps. Then
             each hybrid kernel against its plain version on the card at
             the main path's largest shape (integers bit for bit; float sums
             within a stated tolerance), timed with CUDA events and with
             ``torch.profiler`` (device time; each must list one kernel and
             its memset per call) beside its bound and, where one exists,
             the library call; the prefix scan also from the tail through
             its wrapper and at op sum beside ``torch.cumsum``, the bucket
             router also by its wrapper's host µs per call. Between the
             correctness checks and the kernel rows, on the same frames,
             the profile phase (``profile_phase``): ``calibrate(n=8192,
             repeats=5)`` against the card's f32 and HBM peaks (over 105 %
             fails), the port's fused-stage build time beside
             ``compile_s_per_op``, a third warm run with a ``JobTracer`` on
             the job and the worker (frames bit for bit with the untraced
             run, a valid Chrome trace in ``build/profile/``, one task span
             per finished task, the ``profile/`` metrics mounted, the cost
             history grown by exactly the finished tasks, the hybrid
             kernels launched as untraced), the identity replay against
             the measured makespan (reported beside the reference bench's
             0.75 target), ``lanes=1`` no shorter and two simulations
             identical, and ``price_fn`` of the narrow stage and of the
             calibration matmul (exactly 2n^3 FLOP) against their device
             times, with the scale ``fit()`` sets;
3. apps    — after the hybrid phase's memory is released, the paper's
             evaluation apps (``repro_torch.apps``) on ``p = 8`` ranks, each
             at full size in ignis mode (``APPS``), cold then warm: TeraSort
             (2^26 int32 keys through ``map → sort → count``; the sorted keys
             equal ``np.sort``, the warm run retries no overflow and builds
             no wide plan), PageRank (2^16 vertices, 2^18 edges, 5
             iterations; ranks against a float64 numpy oracle and against
             the ``ignis.kernels=off`` run, every ``segment_totals`` call
             launching the CUDA segmented and prefix scans and every routed
             exchange the bucket router), transitive closure (2^16
             vertices and edges, 10 rounds; the pair set equals a numpy
             oracle's, every routed exchange on the router), K-Means (2^22
             points of 32 dims, 16 centres, 20 iterations: on the device
             and with a driver evaluation per iteration, against each other,
             the last step against numpy's float64 step from the centres
             before it; ``kmeans_mpi`` through ``worker.call``),
             Minebench (2^16 blocks of 16 transactions, 64 nonces at 12
             bits; on one worker and on two with ``import_data`` between
             them; 1024 sampled blocks' roots and nonces against a host
             SHA-256 held to ``hashlib``), the stencil (a 16384 x 16384 f32
             grid, 100 iterations) and CG (2^24 rows, 50 iterations), each
             natively and through ``worker.call`` (equal bit for bit; the
             warm call a plan-cache hit) and against numpy. Each app
             but the native two also runs in ``ignis.mode=spark`` at a shared
             size (K-Means: the driver evaluation at full size) and reports
             the spark/ignis ratio, the pipe's wall, the warm wall against
             the device's busy time (``torch.profiler``), peak memory and
             the hybrid kernels' launches; no app may fall back;
4. recovery — after the apps' memory is released, on ``p = 8`` ranks of
             the card with 8 rank slots (``RECOVERY``): 2^26 (key, value)
             int32 rows (zipf(1.1) keys mod 2^20, as the hybrid's) are
             checkpointed; ``kill_executor(3)`` and a reduceByKey restore
             the lost block from disk (one ``block_restores``, no
             recompute, the source not read again), then every block;
             a corrupt leaf must raise. Chaos: a ``kernel.stage`` kill in
             that reduceByKey, a ``dag.block`` kill in a fused stage and a
             collective kill in a join (the bucket router), each with
             exactly one scheduler retry. Elastic: the persisted rows at
             p = 8, ``shrink(4)``, ``grow(2)`` to 6 and ``grow(2)`` back to
             8, with reduceByKey, sort and join (the router at P = 16, 36,
             64) equal to the static p = 8 run at each size, the
             ``reshard_*`` counters equal to the move/keep rule's count,
             then one ``elastic.reshard`` fault (one hole, repaired
             block-wise). Streaming: 4 tenants of 2^18 rows x 8 int32
             columns on ``worker.groups(4)`` through a ``TenantFrontEnd``
             (4096-row batches, an offset checkpoint every 8), each state
             equal to numpy's int64 column sums; one tenant again with a
             ``stream.batch`` kill at batch 5 and a restart from its
             checkpoint after batch 40, bit identical. Reports save and
             restore ms and GB/s, resize ms apart from the new world's
             autotune sweeps, batches/s and commit latency per tenant,
             and the hybrid kernels' launches (each launched);
5. qwen,   — after the previous phase's memory is released, each model
   mamba,    (random bf16 weights from a seeded generator) serves 8 requests
   mixtral,  of 512–2048 prompt tokens x 32 new tokens on 4 slots of a
   olmo, yi,
   gemma,
   phi
             4096-position slab, each decode tick an IJob task of kind
             ``serve``: Qwen3-14B (every prefill through the flash kernel),
             Mamba2-780M (every prefill's mixers through the SSD scan;
             decode is the O(1) recurrence) and Mixtral-8x7B at 24 of its 32
             layers (flash with its 4096 window; every prefill's and decode
             step's FFNs through the router); then OLMo-1B and Yi-9B (every
             prefill through flash), Gemma3-4B (its uneven local/global
             windows keep the plain attention: no flash launch, checked)
             and Phi-3.5-MoE at 24 of its 32 layers (``PHI_LAYERS``; flash
             and the router with 16 experts, top-2), each timed by its own
             log line; every attention model decodes through the decode
             kernel (Gemma3-4B too: its windows are arguments). Checks:
             every ticket resolves
             with 32 tokens, each kernel's launches equal layers x prefills
             (the router: layers x (prefills + decode steps); the decode
             kernel: layers x decode steps), every flash launch on the
             wgmma route and every decode launch split (``PATH_VARIANT``),
             one more decode step on the run's final cache with the decode
             kernel held at each call's inputs and its logits against the
             plain version's (``hold_decode``; not held for the top-2
             MoE models),
             serve tasks in the job, finite logits, and the kernels' prefill logits against
             the plain versions' on the same weights (Mamba's in an f32 copy
             of the model, after its SSD held layer by layer in bf16).
             Reports prefill ms per
             request, decode ms per tick, tokens/s, request latency, peak
             memory and, for a tick and the longest prefill, the host's
             enqueue time against the device's busy time; then the path's
             new kernel at its largest shape, timed beside its bound, its
             plain version and, for flash, torch's SDPA (the log line also
             gives the earlier design's recorded time, ``RECORDED_EARLIER_MS``,
             which this run does not measure); the router at the largest
             prefill and at a decode tick (T = 4), by device time
             (``torch.profiler``) and the wrapper's host µs per call;
6. jamba,  — after Phi's memory is released, the other families
   internvl, (``FAMILY_PHASES``), random bf16 weights, flash in every
   whisper   prefill: Jamba-1.5-Large at full width, one block of 8 layers
             with 8 of its 16 experts a MoE slot (``JAMBA_LAYERS``,
             ``JAMBA_EXPERTS``), through the engine on the shared traffic
             (flash at the attention slot, G = 8, no RoPE; the SSD scan at
             its 7 mixers, 256 heads; the router at its 4 MoE slots in
             prefill and decode), every admission's splice checked bit for
             bit (the slot equal to the request's own cache, the others
             unchanged: the mixers' state has its batch on axis 2), each
             kernel held at its own inputs in a prefill; InternVL2-1B whole,
             text-only through the engine (the engine feeds token prompts),
             then one batch of 4 x (256 patches + 1024 tokens) through
             ``bundle.prefill(patches=)`` and 32 decode steps; Whisper-tiny
             whole through the bundle (2 batches of 4 clips of 1500 frames,
             256-token prompts, 32 decode steps; 12 flash calls a prefill —
             encoder, decoder self, cross against 1500 keys — and none in
             decode, where the decoder's self-attention takes the decode
             kernel), each kind of flash call held at its first layer's
             inputs, each phase's decode kernel by ``hold_decode``.
             Checks: launches, routes, finite logits, prefill logits
             against the chunked attention's (``SERVE_REL_L2``; Jamba's with
             the router's plain version, ``MOE_REL_L2``). Reports the serve
             cells' figures and each phase's seconds;
7. train   — after the serve phases' memory is released: the paper's
             hybrid training app (``examples/torch_hybrid_train.py``'s
             dataflow phase on a ``cuda`` worker, then ``launch.train`` of
             ``ignis-100m`` on the packed corpus, ``TRAIN_HYBRID``): the
             loss falls, checkpoints at the middle step and the end, the
             saved tree restored bit for bit, a second call resuming from
             the latest step with its steps advancing, and no kernel
             launched (the config's chunked attention); then ``TRAIN_RUNS``
             ``bundle.train_step``s each of OLMo-1B (16 layers, flash,
             remat full), Mamba2-780M (48 layers, the SSD scan) and
             Mixtral-8x7B at ``MIXTRAL_TRAIN_LAYERS`` of its 32 layers (the
             router), random bf16 weights, batches fed by
             ``TrainPipeline`` (each device batch held against its host
             batch). Then InternVL2-1B (``INTERNVL_TRAIN``: 256 patches +
             1792 tokens, flash over S = 2048), Whisper-tiny
             (``WHISPER_TRAIN``: 1500 frames + 448 tokens, 12 flash calls a
             forward) and Jamba's ``value_and_grad`` at full width (one
             block, 4 experts, 1 x 2048, no optimizer step: no full-width
             cut takes an Adam step on one card; the peak reckoned first,
             ``jamba_grad_peak_gib``). Checks: the path's kernels launched
             layers (calls) x steps x 2 times (forward and remat's
             recompute), flash's backward kernel layers (calls) x steps
             times, and no other, every loss (and Jamba's gradient)
             finite, each kernel's ``autograd.Function`` at its first own
             inputs (Whisper: the cross-attention): forward against the
             plain version, backward equal to the plain version's autograd
             bit for bit (flash's backward kernel: against the plain vjp
             in f32 within ``FLASH_BWD_REL_L2``, with its device ms beside
             its bound and the plain vjp's); OLMo's first loss against the chunked attention's
             (``TRAIN_LOSS_REL``); Mixtral's router gradient non-zero with
             the aux loss left out. Reports step ms, tokens/s, peak memory, one step's
             device busy time and idle share, whole-model gradients through
             the kernels against the plain versions (not held: random bf16
             stacks are chaotic), each kernel's forward device ms against
             its plain backward's, and checkpoint save and restore ms; the
             kernels line gains each model kernel's ``train_launches`` and
             ``family_launches`` (the phases of 6 and their train runs);
8. distributed — after the train phase's memory is released, on meshes
             of virtual ranks of the card (``launch.mesh``): Phi-3.5-MoE at
             full width and ``PHI_LAYERS`` layers with ``moe_ep=True``
             under ``make_local_mesh(8, 1)`` (E_loc = 2), one prefill of
             ``EP_PREFILL`` = 8 x 2048 tokens (T_loc = 2048, C = 320 per
             source and expert at 1.25): EP taken in every layer, the router
             launched once per data rank in each (24 x 8) and flash once a
             layer, the router at each call's own logits against its plain
             version, each layer's EP output at its own inputs against EP
             with the plain router, EP against the flat ``moe_ffn_bsd`` at
             capacity factor 8 on layer 0's inputs, finite logits; reports
             the EP prefill against the flat one, the assignments dropped by
             each at 1.25 and each rank's parameter bytes by
             ``param_specs``. OLMo-1B whole as ``PIPE_STAGES`` = 4 stages of
             4 layers under ``make_pp_mesh(4)``, ``PIPE_MICRO`` = 8
             microbatches of 1 x 2048: ``pipeline_apply`` against
             ``reference_apply`` bit for bit, flash launched 8 x 16 times in
             each, both timed. OLMo-1B's params and AdamW state after one
             ``bundle.train_step``, saved, then ``restore_elastic`` of the
             params under (4, 2) and (5, 1) with ``fsdp_tp_zero1``
             (``ELASTIC_RESTORES``): bit for bit, a wrong shape rejected;
             save and restore ms and each placement's bytes a rank. The
             kernels line gains ``ep_launches`` (the router) and
             ``pipeline_launches`` (flash);
9. launch  — after phase 8's memory is released, ``launch/dryrun`` and
             ``launch/submit``, the phase's wall time logged against its
             ``LAUNCH_BUDGET_S`` = 60 s. The sweep: ``run_cell`` for every
             ``ASSIGNED`` arch and each of its ``shape_cells()`` (34 cells)
             on ``make_production_mesh()`` with fake ``cuda`` tensors, and
             on the two-pod mesh for one arch of each family
             (``LAUNCH_MULTI_POD``); the pieces (one layer of each
             signature, and each cell's base) priced first by
             ``dryrun.prefetch`` in ``LAUNCH_WORKERS`` processes. Checks:
             every record ok with the JAX record's keys, ``chips`` the
             mesh's ranks, ``model_flops`` exactly (6 | 2) x active
             params x tokens, the argument bytes exactly the placements'
             sum, every memory and time term finite and non-negative, the
             JSONL read back equal. Reports each cell's ``per_device_total``,
             dominant term and ``step_time_s``, and names the cells over
             the card's memory. Meanwhile ``ignis-submit --attach`` runs a
             driver (the hybrid wordcount at 2^20 words, dataflow and native
             counts against ``np.bincount``) on the card: rc 0, ``job.json``,
             the ``IGNIS_*`` variables the driver saw. Then OLMo-1B (flash)
             on ``make_local_mesh(1, 1)``: a prefill and a train step of
             ``LAUNCH_OLMO`` = 4 x 2048 priced by ``run_cell(cell=)`` and run
             for real through ``step_for_cell``'s ``fn`` (random bf16
             weights): the argument bytes equal the real arguments', and the
             flash calls priced a layer times the layers equal the real
             prefill's launches (held); the predicted peak and step time
             against ``max_memory_allocated`` and CUDA-event ms, the same
             roofline at ``calibrate()``'s rates, and the train step's
             priced kernel calls against its launches (reported). Last, a
             detached submit whose driver's log line is polled for at most
             ``SUBMIT_POLL_S`` and whose process is waited for. The kernels
             line's flash row gains ``dryrun_priced_calls``.

The last two lines are the ``kernels`` JSON object (with the card's name and
power limit just before it) and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate (data sheet)
F32_FLOP_PER_S = 67e12  # H100 SXM f32 rate outside the tensor cores (data sheet)
VOCAB = 1 << 20
#: the kernels of the hybrid path (phase 2); flash attention is the serve path's
HYBRID_KERNELS = ("segment_reduce", "prefix_scan", "bucket_route")


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


_T0 = time.perf_counter()


def log(*a):
    print(f"[{time.perf_counter() - _T0:7.1f} s]", *a, flush=True)


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------


def register_wordcount():
    """The native SPMD app of the hybrid wordcount: a histogram over every
    rank's rows (the torch twin of examples/quickstart.py's app)."""
    import torch

    from repro_torch.core.native import ignis_export

    @ignis_export("wordcount")
    def wordcount(ctx, data=None, valid=None):
        vocab = int(ctx.var("vocab"))
        words = data["word"]
        ids = torch.where(valid, words, vocab).long()
        counts = torch.bincount(ids, minlength=vocab + 1)[:-1].to(torch.int32)
        keys = torch.arange(vocab, dtype=torch.int32, device=words.device)
        return {"key": keys, "value": counts}, counts > 0


def hybrid(w, words, marks, dim_keys, dim_vals):
    import torch

    src = w.parallelize({"word": words, "mark": marks})
    counts = (src.map(lambda r: {"key": r["word"], "value": 1})
              .reduce_by_key(lambda a, b: a + b, 0))
    maxes = (src.map(lambda r: {"key": r["word"], "value": r["mark"]})
             .reduce_by_key(torch.maximum, 0))
    dim = w.parallelize({"key": dim_keys, "value": dim_vals})
    joined = counts.compact().join(dim)
    native = w.call("wordcount", src, vocab=VOCAB)
    return counts, maxes, joined, native


class Spans:
    """Wall-clock intervals (``perf_counter``) of one kind of work, which
    may overlap across the job's threads."""

    def __init__(self):
        self.lock = threading.Lock()
        self.iv = []

    def add(self, t0, t1):
        with self.lock:
            self.iv.append((t0, t1))

    def take(self):
        """(calls, ms of wall covered by at least one interval, summed ms),
        and start afresh."""
        with self.lock:
            iv, self.iv = sorted(self.iv), []
        covered, end = 0.0, float("-inf")
        for a, b in iv:
            if b > end:
                covered += b - max(a, end)
                end = b
        return len(iv), covered * 1e3, sum(b - a for a, b in iv) * 1e3


TO_HOST, SWEEPS = Spans(), Spans()
#: ``segment_totals`` calls with rows, on the path and in autotune sweeps
SEG_CALLS = {"path": 0, "sweep": 0}
#: kernel-routed exchanges (``bucket_route`` calls with rows), likewise
ROUTE_CALLS = {"path": 0, "sweep": 0}
#: while a list, each router call with rows on the path appends copies of
#: its inputs and outputs ``(dest, P, C, pos, keep, counts)``, which
#: ``hold_taped_routes`` holds against ``bucket_route_ref`` after the timed run
ROUTE_TAPE: list | None = None


def instrument():
    """Time two parts of each job with ``perf_counter``: ``to_host`` (the
    driver boundary of collect: blocks to host row trees) after the device
    has finished the work queued before it, and the kernel registry's
    sweeping blocks (capability probes and autotune sweeps); and count the
    ``segment_totals`` calls with rows (``SEG_CALLS``), each of which on the
    path must launch the segmented scan and the prefix scan once, and the
    kernel-routed exchanges (``ROUTE_CALLS``, the ``bucket_route`` calls the
    shuffle's router makes), each of which must launch the bucket router."""
    import contextlib

    import torch

    from repro_torch import kernels
    from repro_torch.core import dataframe
    from repro_torch.kernels import registry
    from repro_torch.kernels.moe_route import ops as route_ops
    from repro_torch.kernels.segment_reduce import ops as seg_ops

    def counting(fn, calls):
        def counted(first, *a, **kw):
            if first.shape[0]:
                calls["sweep" if getattr(kernels._sweep, "on", False) else "path"] += 1
            return fn(first, *a, **kw)
        return counted

    def taped(fn):
        def route(dest, P, C, *a, **kw):
            out = fn(dest, P, C, *a, **kw)
            if (ROUTE_TAPE is not None and dest.shape[0]
                    and not getattr(kernels._sweep, "on", False)):
                ROUTE_TAPE.append((dest.clone(), P, C, *(o.clone() for o in out)))
            return out
        return route

    seg_ops.segment_totals = counting(seg_ops.segment_totals, SEG_CALLS)
    # the shuffle's router looks the function up when it builds a plan, after this
    route_ops.bucket_route = counting(taped(route_ops.bucket_route), ROUTE_CALLS)

    to_host, sweeping = dataframe.to_host, registry.sweeping

    def timed_to_host(block):
        torch.cuda.synchronize()  # what follows is the host's work
        t0 = time.perf_counter()
        out = to_host(block)
        TO_HOST.add(t0, time.perf_counter())
        return out

    @contextlib.contextmanager
    def timed_sweeping():
        t0 = time.perf_counter()
        with sweeping():
            yield
        SWEEPS.add(t0, time.perf_counter())

    dataframe.to_host = timed_to_host
    registry.sweeping = timed_sweeping


def run_job(frames, label, tracer=None):
    """Collect the hybrid frames in one IJob (traced by ``tracer`` if given);
    returns (results, job wall seconds, the job)."""
    import torch

    from repro_torch.core import IJob

    counts, maxes, joined, native = frames
    torch.cuda.reset_peak_memory_stats()
    TO_HOST.take(), SWEEPS.take()
    job = IJob(label)
    if tracer is not None:
        tracer.attach(job)
    t0 = time.perf_counter()
    futs = {
        "counts.collect": counts.collect_async(job=job),
        "native.collect": native.collect_async(job=job),
        "maxes.collect": maxes.collect_async(job=job),
        "join.count": joined.count_async(job=job),
    }
    out = {k: f.result() for k, f in futs.items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    walls = {k: round(f.task.duration_ms, 3) for k, f in futs.items()}
    th, sw = TO_HOST.take(), SWEEPS.take()
    log(f"main[{label}]: job wall {wall * 1e3:.1f} ms; action task ms {walls}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"main[{label}]: to_host {th[0]} calls cover {th[1]:.1f} ms of the job "
        f"wall ({th[2]:.1f} ms summed over threads); sweeps {sw[0]} cover "
        f"{sw[1]:.1f} ms ({sw[2]:.1f} ms summed)")
    return out, wall, job


def kv_arrays(rows):
    """Collected ``{key, value}`` rows as two int64 arrays in the order the
    rows came back; the row dtypes are checked on the way (int32, as the
    reference's)."""
    import numpy as np

    check(all(r["key"].dtype == np.int32 and r["value"].dtype == np.int32
              for r in rows), "collected rows are not int32")
    k = np.fromiter((int(r["key"]) for r in rows), np.int64, len(rows))
    v = np.fromiter((int(r["value"]) for r in rows), np.int64, len(rows))
    return k, v


def by_key(k, v):
    import numpy as np

    order = np.argsort(k, kind="stable")
    return k[order], v[order]


def main_path(args):
    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.core import ICluster, IProperties, IWorker

    n = 1 << args.log2n
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    words = (rng.zipf(1.1, n) % VOCAB).astype(np.int32)
    marks = rng.integers(0, 2**31 - 1, n, dtype=np.int32)
    dim_keys = np.arange(VOCAB, dtype=np.int32)
    dim_vals = ((dim_keys.astype(np.int64) * 2654435761) % 1000003).astype(np.int32)
    exp = np.bincount(words, minlength=VOCAB)
    nz = np.nonzero(exp)[0]
    # the numpy oracle of reduceByKey(max): sort (word, mark) pairs; each
    # word's largest mark ends its run
    pairs = np.sort((words.astype(np.int64) << 31) | marks)
    exp_max = pairs[np.cumsum(exp)[nz] - 1] & (2**31 - 1)
    del pairs
    log(f"main: N={n} words (zipf 1.1 mod 2^20) with random int32 marks, "
        f"p={args.p}, {len(nz)} distinct; data and oracles made in "
        f"{time.perf_counter() - t0:.1f} s")
    register_wordcount()
    instrument()

    def worker(mode):
        return IWorker(ICluster(IProperties({
            "ignis.device": "cuda", "ignis.executor.instances": str(args.p),
            "ignis.kernels": mode})), "python")

    w = worker("auto")
    frames = hybrid(w, words, marks, dim_keys, dim_vals)
    results, launches = [], []
    for pkg in ("segment_reduce", "ssd_scan", "moe_route"):
        check(importlib.util.find_spec(f"repro_torch.kernels.{pkg}._triton") is None,
              f"a Triton kernel is still in the port's {pkg}")
    for run in (1, 2):
        before = w.metrics()
        K.reset_launches()
        SEG_CALLS.update(path=0, sweep=0)
        ROUTE_CALLS.update(path=0, sweep=0)
        out, wall, _job = run_job(frames, f"auto run {run}")
        results.append(out)
        fns = K.launch_counters()
        launches.append({k: (fns[k].launches, fns[k].tune_launches,
                             sorted(fns[k].geometries)) for k in HYBRID_KERNELS})
        after = w.metrics()
        log(f"main[auto run {run}]: launches "
            f"{ {k: v[0] for k, v in launches[-1].items()} } "
            f"(autotune sweeps apart: { {k: v[1] for k, v in launches[-1].items()} }); "
            f"segment_totals calls {SEG_CALLS}, routed exchanges {ROUTE_CALLS}")
        for k, (cnt, _t, _g) in launches[-1].items():
            check(cnt > 0, f"run {run}: kernel {k} was never launched")
        for k in ("segment_reduce", "prefix_scan"):
            check(fns[k].launches == SEG_CALLS["path"],
                  f"run {run}: {SEG_CALLS['path']} segment_totals calls on the path against "
                  f"{fns[k].launches} {k} launches")
        check(fns["bucket_route"].launches == ROUTE_CALLS["path"],
              f"run {run}: {ROUTE_CALLS['path']} routed exchanges on the path against "
              f"{fns['bucket_route'].launches} bucket_route launches")
        check(after["kernels"]["kernel_fallbacks"] == 0, "a kernel fell back")
        if run == 2:
            d_retry = (after["shuffle"]["overflow_retries"]
                       - before["shuffle"]["overflow_retries"])
            d_plans = (after["shuffle"]["wide_plan_misses"]
                       - before["shuffle"]["wide_plan_misses"])
            log(f"main[auto run 2]: new overflow_retries={d_retry}, "
                f"new wide_plan_misses={d_plans}")
            check(d_retry == 0, "overflow retries on the repeated run")
            check(d_plans == 0, "new wide-plan compiles on the repeated run")
    log(f"main: shuffle {w.metrics('shuffle')}")
    log(f"main: kernels {w.metrics('kernels')}")

    off = run_job(hybrid(worker("off"), words, marks, dim_keys, dim_vals), "off")[0]

    # correctness: each frame against its numpy oracle (rows sorted by key),
    # and the kernel runs against off row for row in the order they came back
    oracle = {"counts.collect": exp[nz], "native.collect": exp[nz],
              "maxes.collect": exp_max}
    rows = {label: {key: kv_arrays(v) if isinstance(v, list) else v
                    for key, v in res.items()}
            for label, res in (("auto 1", results[0]), ("auto 2", results[1]),
                               ("off", off))}
    for label, res in rows.items():
        for key, want in oracle.items():
            k, v = by_key(*res[key])
            check(np.array_equal(k, nz) and np.array_equal(v, want),
                  f"{label}: {key} differs from its numpy oracle")
        check(res["join.count"] == len(nz), f"{label}: join rows")
    for label in ("auto 1", "auto 2"):
        for key, want in rows["off"].items():
            got = rows[label][key]
            same = (all(np.array_equal(a, b) for a, b in zip(got, want))
                    if isinstance(want, tuple) else got == want)
            check(same, f"{label}: {key} differs from the ignis.kernels=off run")
    log("main: counts == np.bincount, native == np.bincount, maxes == numpy "
        "oracle, kernel runs == off (bit for bit, row for row in collected "
        "order), join rows == distinct words: OK")
    t0 = time.perf_counter()
    profile_phase(w, frames, rows["auto 2"], launches[1], wall)
    log(f"profile: phase took {time.perf_counter() - t0:.1f} s")
    return launches[0]


# ---------------------------------------------------------------------------
# the profile package on the hybrid path's frames
# ---------------------------------------------------------------------------

#: the calibration probes' size: an (n, n) f32 matmul (2n^3 FLOP, some 22 ms
#: on the card) and copy-scale (2 x 256 MiB)
PROFILE_N = 8192
#: the reference bench's target for the identity replay (benchmarks/
#: bench_cost_model.py: predicted makespan within 25 % of the measured)
REPLAY_TARGET = 0.75


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    return smi[0] if smi else "nvidia-smi gave nothing"


def profile_phase(w, frames, warm_rows, warm_launches, warm_wall):
    """The profile package on the card, on the hybrid path's frames before
    their memory is released: ``calibrate`` (rates against the card's
    published f32 and HBM peaks; none may read over 105 %); the port's
    fused-stage build time beside ``DeviceParams.compile_s_per_op``; a third
    warm run of the hybrid job with a ``JobTracer`` on the job and the
    worker (frames bit for bit with the untraced warm run, a valid Chrome
    trace saved under ``build/`` with one task span per finished task, the
    summary mounted as ``profile/``, the cost history grown by exactly the
    finished tasks, the hybrid kernels launched as in the untraced run);
    the captured trace replayed (identity against the measured makespan,
    ``lanes=1`` no shorter, two simulations identical); and ``price_fn`` of
    the hybrid's narrow stage on its real blocks and of the calibration
    matmul (exactly 2n^3 FLOP) against their device times."""
    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.core.dag import DagEngine, FusedStage
    from repro_torch.profile import (CostModel, DeviceParams, Hypothesis, JobTracer,
                                     calibrate, capture, simulate, validate)

    gpu = card()
    t0 = time.perf_counter()
    params = calibrate(n=PROFILE_N, repeats=5)
    shares = {"flops": params.flops_per_s / F32_FLOP_PER_S,
              "hbm": params.hbm_bytes_per_s / HBM_BYTES_PER_S}
    log(f"profile: calibrate(n={PROFILE_N}, repeats=5) in {time.perf_counter() - t0:.2f} s "
        f"on {gpu}: flops_per_s {params.flops_per_s:.6e} ({shares['flops']:.4f} of the "
        f"f32 non-tensor peak {F32_FLOP_PER_S:.3e}), hbm_bytes_per_s "
        f"{params.hbm_bytes_per_s:.6e} ({shares['hbm']:.4f} of {HBM_BYTES_PER_S:.3e}), "
        f"dispatch_s {params.dispatch_s:.6e}")
    for k, share in shares.items():
        check(share <= 1.05, f"profile: calibrated {k} rate reads {share:.3f} of the card's peak")

    # the hybrid's narrow stage (counts' map over the source blocks), built
    # as a fused stage on an engine of its own, whose empty plan cache makes
    # the call a miss: the port's whole stage build
    map_node = frames[0].node.parents[0]
    blocks = map_node.parents[0].result
    stage = FusedStage([map_node])
    fresh = DagEngine()
    t0 = time.perf_counter()
    stage_fn = fresh._compiled(stage, blocks[0])
    build_s = time.perf_counter() - t0
    plan = {k: fresh.stats[f"plan_cache_{k}"] for k in ("misses", "hits")}
    check(plan == {"misses": 1, "hits": 0}, f"profile: the stage build was not one plan-cache "
          f"miss: {plan}")
    log(f"profile: fused-stage build ({stage.describe()}, {len(stage.nodes)} op, plan cache "
        f"{plan}) {build_s:.6e} s per op, beside DeviceParams.compile_s_per_op = "
        f"{DeviceParams().compile_s_per_op} s (the reference's XLA compile figure, kept so "
        f"the fusion decisions stay the reference's)")

    # the traced warm run
    tracer = JobTracer()
    tracer.attach_worker(w)
    check(tracer.cost is w.engine.cost_model, "profile: the tracer did not adopt the "
          "engine's cost model")
    before = w.engine.cost_model.snapshot()["tasks_observed"]
    K.reset_launches()
    SEG_CALLS.update(path=0, sweep=0)
    ROUTE_CALLS.update(path=0, sweep=0)
    out, wall, job = run_job(frames, "traced", tracer)
    fns = K.launch_counters()
    launches = {k: (fns[k].launches, fns[k].tune_launches, sorted(fns[k].geometries))
                for k in HYBRID_KERNELS}
    tracer.detach()
    check(launches == warm_launches, f"profile: traced launches {launches} differ from the "
          f"untraced run's {warm_launches}")
    for key, want in warm_rows.items():
        got = kv_arrays(out[key]) if isinstance(out[key], list) else out[key]
        same = (all(np.array_equal(a, b) for a, b in zip(got, want))
                if isinstance(want, tuple) else got == want)
        check(same, f"profile: traced {key} differs from the untraced warm run")
    finished = [t for t in job.tasks if t.t_end]
    check(finished and all(t.state == "done" for t in finished),
          f"profile: task states {[t.state for t in job.tasks]}")
    trace = tracer.to_chrome()
    problems = validate(trace)
    check(not problems, f"profile: the Chrome trace is not valid: {problems[:4]}")
    path = os.path.join(HERE, "build", "profile", "hybrid_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tracer.save(path)
    with open(path, encoding="utf-8") as f:
        saved = json.load(f)
    task_spans = sorted(e["args"]["task"] for e in saved["traceEvents"]
                        if e.get("ph") == "X" and e.get("cat") == "task"
                        and e["name"] not in ("compute", "settle"))
    check(task_spans == sorted(t.name for t in finished),
          f"profile: saved task spans {task_spans} against finished tasks "
          f"{sorted(t.name for t in finished)}")
    summary, mounted = tracer.summary(), w.metrics("profile")
    check(mounted.keys() == summary.keys() and mounted["tasks"] == len(finished),
          f"profile: worker.metrics('profile') {mounted} against the summary {summary}")
    observed = w.engine.cost_model.snapshot()["tasks_observed"] - before
    check(observed == len(finished), f"profile: the cost history grew by {observed} for "
          f"{len(finished)} finished tasks")
    log(f"profile: traced warm run {wall * 1e3:.1f} ms against the untraced warm run "
        f"{warm_wall * 1e3:.1f} ms; {summary['spans']} spans ({summary['engine_spans']} "
        f"engine), {summary['tasks']} task spans = {len(finished)} finished tasks, saved to "
        f"{os.path.relpath(path, HERE)}; compute {summary['compute_ms']:.1f} ms, lock wait "
        f"{summary['lock_wait_ms']:.1f} ms, settle {summary['settle_ms']:.1f} ms; cost "
        f"history +{observed}; launches as untraced "
        f"{ {k: v[0] for k, v in launches.items()} }: OK")

    # replay of the captured job
    tr = capture(job)
    ident = simulate(tr)
    serial = simulate(tr, Hypothesis(lanes=1))
    ratio = ident.makespan_s / tr.wall_s
    log(f"profile: replay of {len(tr.tasks)} tasks on {len(tr.lanes())} lanes: identity "
        f"predicts {ident.makespan_s * 1e3:.3f} ms against {tr.wall_s * 1e3:.3f} ms measured, "
        f"ratio {ratio:.4f}, accuracy {min(ratio, 1 / ratio):.4f} (the reference bench's "
        f"target: {REPLAY_TARGET}, reported, not gated); lanes=1 predicts "
        f"{serial.makespan_s * 1e3:.3f} ms")
    check(serial.makespan_s >= ident.makespan_s * (1 - 1e-12),
          "profile: lanes=1 predicts a shorter makespan than the identity")
    check(simulate(tr) == ident, "profile: two simulations of one trace differ")

    # static pricing against device time, under the calibrated params
    model = CostModel(params)
    est = model.price_fn(stage_fn, blocks[0].data, blocks[0].valid, nblocks=len(blocks))
    pred = model.predict_s(est)
    dev = device_ms(lambda: [stage_fn(b.data, b.valid) for b in blocks])
    check(dev is not None, "profile: the profiler saw no device time in the stage")
    a = torch.ones((PROFILE_N, PROFILE_N), dtype=torch.float32, device="cuda")
    mm = model.price_fn(torch.mm, a, a)
    check(mm.flops == 2 * PROFILE_N**3, f"profile: the matmul priced {mm.flops} FLOP, "
          f"not 2n^3 = {2 * PROFILE_N**3}")
    mm_dev = device_ms(lambda: torch.mm(a, a), reps=5)
    check(mm_dev is not None, "profile: the profiler saw no device time in the matmul")
    mm_pred = model.predict_s(mm)
    log(f"profile: price_fn of the narrow stage over {len(blocks)} blocks "
        f"{[tuple(t.shape) for t in blocks[0].data.values()]}: {est.flops:.0f} FLOP, "
        f"{est.hbm_bytes:.0f} bytes, {est.dispatches:.0f} dispatches; predicted "
        f"{pred * 1e3:.6f} ms against {dev:.6f} ms device time; the matmul: "
        f"{mm.flops:.0f} FLOP = 2n^3, predicted {mm_pred * 1e3:.6f} ms against "
        f"{mm_dev:.6f} ms device time")
    scale = model.fit([(pred, dev / 1e3)])
    log(f"profile: fit() on the stage sets scale {scale:.6f}; the matmul's prediction "
        f"becomes {model.predict_s(mm) * 1e3:.6f} ms")
    del a


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a, b) -> float:
    import torch

    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def rel_l2(got, ref) -> float:
    """Relative L2 of ``got - ref`` against ``ref``, in f32."""
    ref = ref.float()
    return float((got.float() - ref).norm() / ref.norm().clamp_min(1e-30))


def exact(a, b, what):
    import torch

    check(a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b),
          f"{what}: kernel differs from its plain version")


class _Rand:
    """Seeded inputs on the card."""

    def __init__(self, seed: int):
        import torch

        self.dev = torch.device("cuda")
        self.g = torch.Generator(device=self.dev)
        self.g.manual_seed(seed)

    def ints(self, n, lo=-1000, hi=1000, shape=None):
        import torch

        return torch.randint(lo, hi, shape or (n,), generator=self.g,
                             device=self.dev, dtype=torch.int32)

    def rand(self, *shape):
        import torch

        return torch.rand(shape, generator=self.g, device=self.dev)


#: the segmented scan's blocks (threads per block) the autotune sweeps by
#: default (``ignis.kernels.blocks``); its row reports the fastest
SEG_BLOCKS = (128, 256, 512)


def same_bits(a, b, nan_rows=False) -> bool:
    """``a`` equals ``b`` bit for bit (an f32 NaN's payload and a zero's sign
    count); with ``nan_rows``, NaN at the same rows and the other rows bit
    for bit (a sum's NaN is whichever the hardware's add makes)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    if nan_rows:
        na, nb = torch.isnan(a), torch.isnan(b)
        return torch.equal(na, nb) and torch.equal(a[~na].view(torch.int32),
                                                   b[~nb].view(torch.int32))
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def kernel_checks(main_launches, reps: int):
    """Each kernel against its plain version at the main path's largest
    shape, then timed beside its bound, its plain version and the library
    call where one exists."""
    import torch

    from repro_torch.kernels.moe_route.ref import bucket_route_ref
    from repro_torch.kernels.moe_route.route import bucket_route_fwd
    from repro_torch.kernels.segment_reduce.ref import segment_scan_plain
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_reduce_fwd
    from repro_torch.kernels.ssd_scan.ops import prefix_scan
    from repro_torch.kernels.ssd_scan.prefix import prefix_scan_fwd
    from repro_torch.kernels.ssd_scan.ref import prefix_scan_ref

    r = _Rand(0)

    def largest(name):
        return max(main_launches[name][2], key=lambda gm: gm[0][0])

    rows = []

    (n, d), op = largest("segment_reduce")
    v = r.ints(n, shape=(n, d))
    hb = r.rand(n) < 0.05
    hb[0] = True
    fwd, plain = segment_reduce_fwd, segment_scan_plain
    ref = plain(v, hb, op)
    ms_by_block, err = {}, 0.0
    for block in SEG_BLOCKS:  # as the autotune sweeps them
        got = fwd(v, hb, op=op, block=block)
        exact(got, ref, f"segment_reduce {n}x{d} {op} block={block}")
        err = max(err, max_err(got, ref))
        ms_by_block[block] = time_ms(lambda: fwd(v, hb, op=op, block=block), reps)
    best = min(ms_by_block, key=ms_by_block.get)
    nbytes = 2 * n * d * 4 + n  # values in, scan out, flags in
    by_ms, per_call = device_profile(lambda: fwd(v, hb, op=op, block=best))
    check(set(per_call) == {"scan_kernel<Segmented>", "Memset"}
          and all(c == 1 for c in per_call.values()),
          f"segment_reduce: the profiler lists {per_call} launches per call, not one "
          f"kernel and its memset")
    rows.append(dict(
        name="segment_reduce", route="cuda", source="src/repro_torch/csrc/segment_reduce.cu",
        replaces="src/repro/kernels/segment_reduce/segment_reduce.py:56",
        launches=main_launches["segment_reduce"][0], max_abs_err=err, ms=ms_by_block[best],
        plain_ms=time_ms(lambda: plain(v, hb, op), max(reps // 4, 2)),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None, device_ms=round(sum(by_ms.values()), 6),
        device_ms_by_kernel=by_ms, launches_per_call=per_call, block=best,
        ms_by_block=ms_by_block, shape=[n, d], op=op))
    del v, hb, ref, got

    (n,), op, _rev = largest("prefix_scan")
    x = r.ints(n, 0, n)
    fwd, plain = prefix_scan_fwd, prefix_scan_ref
    ref = plain(x, op)
    ms_by_block, err = {}, 0.0
    for block in SEG_BLOCKS:  # segment_totals passes its tuned block through
        got = fwd(x, op=op, block=block)
        check(same_bits(got, ref), f"prefix_scan {n} {op} block={block}: differs")
        err = max(err, max_err(got, ref))
        ms_by_block[block] = time_ms(lambda: fwd(x, op=op, block=block), reps)
    best = min(ms_by_block, key=ms_by_block.get)
    by_ms, per_call = device_profile(lambda: fwd(x, op=op, block=best))
    rev_ms, rev_call = device_profile(lambda: fwd(x, op=op, block=best, reverse=True))
    for what, calls in (("Prefix", per_call), ("PrefixReverse", rev_call)):
        check(set(calls) == {f"scan_kernel<{what}>", "Memset"}
              and all(c == 1 for c in calls.values()),
              f"prefix_scan ({what}): the profiler lists {calls} launches per call, not one "
              f"kernel and its memset")
    got = prefix_scan(x, op=op, block=best, reverse=True)  # as segment_totals calls it
    check(same_bits(got, plain(x, op, reverse=True)), f"prefix_scan {n} {op} reverse: differs")
    got = fwd(x, op="sum", block=best)
    check(same_bits(got, torch.cumsum(x, 0, dtype=x.dtype)), f"prefix_scan {n} sum: differs")
    lib = {"min": lambda: torch.cummin(x, 0), "max": lambda: torch.cummax(x, 0),
           "sum": lambda: torch.cumsum(x, 0, dtype=x.dtype)}[op]
    rows.append(dict(
        name="prefix_scan", route="cuda", source="src/repro_torch/csrc/segment_reduce.cu",
        replaces="src/repro/kernels/ssd_scan/prefix.py:54",
        launches=main_launches["prefix_scan"][0], max_abs_err=err, ms=ms_by_block[best],
        plain_ms=time_ms(lambda: plain(x, op), max(reps // 4, 2)),
        bound_ms=2 * n * 4 / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=time_ms(lib, max(reps // 4, 2)),
        device_ms=round(sum(by_ms.values()), 6), device_ms_by_kernel=by_ms,
        launches_per_call=per_call, block=best, ms_by_block=ms_by_block,
        reverse_device_ms=round(sum(rev_ms.values()), 6),
        wrapper_reverse_ms=time_ms(lambda: prefix_scan(x, op=op, block=best, reverse=True), reps),
        sum_ms=time_ms(lambda: fwd(x, op="sum", block=best), reps),
        cumsum_ms=time_ms(lambda: torch.cumsum(x, 0, dtype=x.dtype), reps),
        shape=[n], op=op))
    del x, ref, got

    (n,), P, C = largest("bucket_route")
    dest = r.ints(n, 0, P)
    fwd, plain = bucket_route_fwd, bucket_route_ref
    ref = plain(dest, P, C)
    # device time by block: CUDA events around back-to-back calls time the
    # host's issue rate here, not the kernel (as for the MoE router)
    ms_by_block = {}
    for block in SEG_BLOCKS:  # as the autotune sweeps them
        got = fwd(dest, P, C, block=block)
        for a, b, nm in zip(got, ref, ("pos", "keep", "counts")):
            exact(a, b, f"bucket_route {n} P={P} C={C} block={block} {nm}")
        ms_by_block[block] = device_ms(lambda: fwd(dest, P, C, block=block), 50)
    check(None not in ms_by_block.values(), "bucket_route: the profiler saw no device time")
    best = min(ms_by_block, key=ms_by_block.get)
    call = lambda: fwd(dest, P, C, block=best)  # noqa: E731
    by_ms, per_call = device_profile(call, 50)
    check(set(per_call) == {"bucket_route_kernel", "Memset"}
          and all(c == 1 for c in per_call.values()),
          f"bucket_route: the profiler lists {per_call} launches per call, not one kernel and "
          f"its memset")
    rows.append(dict(
        name="bucket_route", route="cuda", source="src/repro_torch/csrc/bucket_route.cu",
        replaces="src/repro/kernels/moe_route/route.py:50",
        launches=main_launches["bucket_route"][0],
        max_abs_err=max(max_err(a, b) for a, b in zip(got, ref)), ms=ms_by_block[best],
        event_ms=time_ms(call, reps * 10), plain_ms=time_ms(lambda: plain(dest, P, C), reps),
        bound_ms=(n * 4 + n * 4 + n + P * 4) / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=None, device_ms=round(sum(by_ms.values()), 6),
        device_ms_by_kernel=by_ms, launches_per_call=per_call, block=best,
        ms_by_block=ms_by_block, host_us=host_us(call), shape=[n], p=P, capacity=C))
    for row in rows:
        lib = row["library_ms"]
        earlier = RECORDED_EARLIER_MS.get(row["name"])
        log(f"kernel {row['name']}: shape {row['shape']} launches {row['launches']} "
            f"max_abs_err {row['max_abs_err']} | "
            + (f"{row['ms']:.4f} ms (CUDA events), device {row['device_ms']} ms (torch.profiler)"
               if "event_ms" not in row else
               f"{row['ms']:.6f} ms device (torch.profiler; CUDA events over back-to-back "
               f"calls, the host's issue rate here: {row['event_ms']:.4f} ms)")
            + (f" (earlier design {earlier} ms as recorded, not measured here)" if earlier else "")
            + f" vs bound {row['bound_ms']:.4f} ms (bytes / 3.35 TB/s) | plain "
            f"{row['plain_ms']:.4f} ms | library "
            f"{'none' if lib is None else f'{lib:.4f} ms'}"
            + (f"; block {row['block']} of {row['ms_by_block']} ms; device ms per launch "
               f"{row['device_ms_by_kernel']}, launches per call {row['launches_per_call']}"
               if "launches_per_call" in row else "")
            + (f"; reverse: device {row['reverse_device_ms']} ms, through the wrapper "
               f"{row['wrapper_reverse_ms']:.4f} ms; sum {row['sum_ms']:.4f} ms against "
               f"torch.cumsum {row['cumsum_ms']:.4f} ms" if "sum_ms" in row else "")
            + (f"; wrapper host {row['host_us']:.2f} us per call" if "host_us" in row else ""))
    return rows


# ---------------------------------------------------------------------------
# the paper's evaluation apps (phase apps)
# ---------------------------------------------------------------------------

#: the apps phase's sizes: full size in ignis mode, and the shared size of
#: the ignis/spark comparison. Two counts are cut. PageRank runs 2^18 edges
#: over 2^16 vertices, not 2^22 over 2^20: every wide op of its loop pads
#: its output to p times its input's capacity (as the reference's does),
#: and the action holds every frame of the 5 iterations, some 58 GiB at
#: 2^18 edges on the card. Transitive closure runs 2^16 vertices and
#: edges, not 2^18: ``distinct`` keys an (a, b) pair by the reference's
#: default packing ``(a << 16) | (b & 0xFFFF)``, which holds vertex ids
#: below 2^16 only (the phase counts, from its host oracle, the pairs at
#: 2^18 that share a key).
APPS = dict(
    terasort=dict(n=1 << 26, spark_n=1 << 18),
    pagerank=dict(vertices=1 << 16, edges=1 << 18, iters=5, spark=(1 << 12, 1 << 14)),
    tc=dict(vertices=1 << 16, edges=1 << 16, rounds=10, matches=16, spark=(1 << 10, 1 << 10),
            packed_check=(1 << 18, 1 << 18)),
    kmeans=dict(n=1 << 22, d=32, k=16, iters=20),
    minebench=dict(blocks=1 << 16, txs=16, iters=64, bits=12, spark_blocks=1 << 12,
                   sample=1024),
    stencil=dict(rows=16384, cols=16384, iters=100, check_iters=2),
    cg=dict(n=1 << 24, iters=50),
)
#: the device the phase runs on (only a rehearsal on the CPU changes it)
APP_DEVICE = "cuda"
PAGERANK_RTOL = 1e-5  # f32 ranks against the f64 oracle, and kernels against off
KMEANS_ATOL = 5e-3  # centres: f32 sums of some 2^18 points a centre (GEMM order)
STENCIL_ATOL = 1e-6  # 2 Jacobi steps against numpy in f32, the same adds
CG_REL_L2 = 1e-5  # 50 f32 CG steps against numpy's f64 CG
PIPE = Spans()  # spark mode's driver pipe (``IWorker._pipe_block``)
APP_REPORT: dict = {}


def app_worker(mode="ignis", kernels="auto", kind="python", p=8):
    from repro_torch.core import ICluster, IProperties, IWorker

    return IWorker(ICluster(IProperties({
        "ignis.device": APP_DEVICE, "ignis.executor.instances": str(p),
        "ignis.kernels": kernels, "ignis.mode": mode})), kind)


def timed(fn):
    """(fn's result, host ms to the device's end)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def device_busy_ms(fn, what=None):
    """(host ms to the device's end, device busy ms) of one call of ``fn``
    under ``torch.profiler`` (CUDA activity; the sum of the device's kernel
    and copy times: one stream, so they do not overlap); busy is None where
    the profiler sees no device time. With ``what``, the six heaviest
    kernels are logged under it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, ms = timed(fn)
    evs = [e for e in prof.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA]
    for e in sorted(evs, key=dev_us, reverse=True)[:6] if what else ():
        log(f"where: {what}:   {dev_us(e) / 1e3:9.3f} ms in {e.count:5d} launches of "
            f"{e.key[:90]}")
    us = sum(dev_us(e) for e in evs)
    return ms, (us / 1e3 if us else None)


def start_app():
    """Release the previous app's memory and zero every counter the next
    run reads: kernel launches, ``segment_totals`` calls and routed
    exchanges, the peak of device memory, ``to_host`` and pipe spans."""
    import gc

    import torch

    from repro_torch import kernels as K

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    SEG_CALLS.update(path=0, sweep=0)
    ROUTE_CALLS.update(path=0, sweep=0)
    TO_HOST.take(), PIPE.take()


def app_launches(name, must=()):
    """The hybrid kernels' launches since ``start_app`` (autotune sweeps
    apart); every kernel in ``must`` launched, and each ``segment_totals``
    call (routed exchange) launched the scans (the router) once."""
    from repro_torch import kernels as K

    fns = K.launch_counters()
    got = {k: fns[k].launches for k in HYBRID_KERNELS}
    for k in must:
        check(got[k] > 0, f"apps: {name}: kernel {k} was never launched")
    if "segment_reduce" in must:
        for k in ("segment_reduce", "prefix_scan"):
            check(got[k] == SEG_CALLS["path"],
                  f"apps: {name}: {SEG_CALLS['path']} segment_totals calls against "
                  f"{got[k]} {k} launches")
    if "bucket_route" in must:
        check(got["bucket_route"] == ROUTE_CALLS["path"],
              f"apps: {name}: {ROUTE_CALLS['path']} routed exchanges against "
              f"{got['bucket_route']} bucket_route launches")
    return got


def no_fallback(name, *workers):
    for w in workers:
        check(w.metrics("kernels")["kernel_fallbacks"] == 0, f"apps: {name}: a kernel fell back")


def report(name, **kw):
    """Log and keep one app's numbers: the peak of device memory since
    ``start_app``, and what the caller measured."""
    import torch

    kw.update(peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))
    if kw.get("wall_ms") and kw.get("busy_ms") is not None:
        kw["idle_share"] = round(max(0.0, 1 - kw["busy_ms"] / kw["wall_ms"]), 3)
    APP_REPORT[name] = kw
    log(f"apps: {name}: " + ", ".join(f"{k} {v}" for k, v in kw.items()))


def spark_ratio(run, label, prefix=""):
    """``run(worker)`` on an ignis and on a spark worker, each called twice:
    ({mode: the second call's result, which the caller holds the modes
    to}, {the second calls' ms, their spark/ignis ratio, and the wall the
    spark run spent in the driver pipe})."""
    out, ms = {}, {}
    for mode in ("ignis", "spark"):
        w = app_worker(mode)
        run(w)  # cold: plans, sweeps
        PIPE.take()
        out[mode], ms[mode] = timed(lambda: run(w))
        pipe = PIPE.take()
        no_fallback(f"{label} ({mode})", w)
    return out, {f"{prefix}ignis_ms": round(ms["ignis"], 1),
                 f"{prefix}spark_ms": round(ms["spark"], 1),
                 f"{prefix}spark_over_ignis": round(ms["spark"] / ms["ignis"], 2),
                 f"{prefix}spark_pipe_ms": round(pipe[1], 1),
                 f"{prefix}spark_pipe_blocks": pipe[0]}


def _valid_rows(df):
    """The valid rows of a frame's blocks, concatenated in block order, as
    host arrays (one per leaf) — read through ``_blocks()``, never through
    ``collect()``'s row dicts."""
    return _block_rows(df._blocks())


def _block_rows(blocks):
    """The valid rows of ``blocks``, concatenated in block order, as host
    arrays (one per leaf)."""
    import numpy as np

    from repro_torch.core import tree

    valid = [b.valid.cpu().numpy() for b in blocks]
    leaves = [tree.leaves(b.data) for b in blocks]
    return [np.concatenate([ls[i].cpu().numpy()[v] for ls, v in zip(leaves, valid)])
            for i in range(len(leaves[0]))]


def app_terasort():
    import numpy as np

    cfg = APPS["terasort"]
    start_app()
    keys = np.random.default_rng(0).integers(0, 2**31 - 1, cfg["n"], dtype=np.int32)

    def run(w, k=keys):
        return w.parallelize(k).map(lambda x: x).sort()

    w = app_worker()
    df = run(w)
    n, cold = timed(df.count)
    start_app()
    before = w.metrics("shuffle")
    n2, warm = timed(df.count)
    after = w.metrics("shuffle")
    d_retry = after["overflow_retries"] - before["overflow_retries"]
    d_plans = after["wide_plan_misses"] - before["wide_plan_misses"]
    check(n == n2 == cfg["n"], f"apps: terasort counted {n}, {n2} of {cfg['n']} keys")
    check(d_retry == 0 and d_plans == 0,
          f"apps: terasort warm run: {d_retry} overflow retries, {d_plans} new wide plans")
    busy_wall, busy = device_busy_ms(df.count)
    (got,) = _valid_rows(df)
    check(np.array_equal(got, np.sort(keys)), "apps: terasort keys differ from np.sort")
    no_fallback("terasort", w)
    del df, got
    small = keys[: cfg["spark_n"]]
    out, spark = spark_ratio(lambda w: _valid_rows(run(w, small))[0], "terasort")
    for mode, rows in out.items():
        check(np.array_equal(rows, np.sort(small)), f"apps: terasort ({mode}) differs from np.sort")
    report("terasort", n=cfg["n"], cold_ms=round(cold, 1), wall_ms=round(warm, 1),
           mkeys_per_s=round(cfg["n"] / warm / 1e3, 2), busy_ms=busy, busy_wall_ms=round(busy_wall, 1),
           new_overflow_retries=d_retry, new_wide_plans=d_plans,
           launches=app_launches("terasort"), spark_n=cfg["spark_n"], **spark)


def pagerank_oracle(edges, n_vertices, iters, damping=0.85):
    """float64 PageRank over the vertex list (``pagerank_reference``'s
    iteration with ``np.bincount``): (sorted vertices, ranks)."""
    import numpy as np

    src, dst = edges[:, 0], edges[:, 1]
    deg = np.bincount(src, minlength=n_vertices).astype(np.float64)
    verts = np.unique(edges)
    ranks = np.zeros(n_vertices)
    ranks[verts] = 1.0
    for _ in range(iters):
        sums = np.bincount(dst, weights=ranks[src] / deg[src], minlength=n_vertices)
        ranks = np.zeros(n_vertices)
        ranks[verts] = (1 - damping) + damping * sums[verts]
    return verts, ranks[verts]


def _rank_array(ranks: dict, verts):
    import numpy as np

    check(sorted(ranks) == [int(v) for v in verts], "apps: pagerank's vertex set differs")
    return np.fromiter((ranks[int(v)] for v in verts), np.float64, len(verts))


def _max_rel(got, want):
    import numpy as np

    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))


def app_pagerank():
    from repro_torch.apps.graph import make_graph, pagerank

    cfg = APPS["pagerank"]
    start_app()
    edges = make_graph(cfg["vertices"], cfg["edges"], seed=0)
    verts, want = pagerank_oracle(edges, cfg["vertices"], cfg["iters"])
    w = app_worker()
    _, cold = timed(lambda: pagerank(w, edges, iters=cfg["iters"]))
    start_app()
    ranks, warm = timed(lambda: pagerank(w, edges, iters=cfg["iters"]))
    launches = app_launches("pagerank", must=HYBRID_KERNELS)
    calls = dict(segment_totals=SEG_CALLS["path"], routed_exchanges=ROUTE_CALLS["path"])
    to_host = TO_HOST.take()
    busy_wall, busy = device_busy_ms(lambda: pagerank(w, edges, iters=cfg["iters"]))
    got = _rank_array(ranks, verts)
    err = _max_rel(got, want)
    check(err <= PAGERANK_RTOL, f"apps: pagerank: max relative error {err} against the oracle")
    off = _rank_array(pagerank(app_worker(kernels="off"), edges, iters=cfg["iters"]), verts)
    err_off = _max_rel(got, off)
    check(err_off <= PAGERANK_RTOL,
          f"apps: pagerank: max relative difference {err_off} from ignis.kernels=off")
    no_fallback("pagerank", w)
    small = make_graph(*cfg["spark"], seed=0)
    sv, swant = pagerank_oracle(small, cfg["spark"][0], cfg["iters"])
    out, spark = spark_ratio(
        lambda w: _rank_array(pagerank(w, small, iters=cfg["iters"]), sv), "pagerank")
    for mode, got_s in out.items():
        e = _max_rel(got_s, swant)
        check(e <= PAGERANK_RTOL, f"apps: pagerank ({mode}, small): max relative error {e}")
    report("pagerank", vertices=len(verts), edges=len(edges), iters=cfg["iters"],
           cold_ms=round(cold, 1), wall_ms=round(warm, 1),
           edge_iters_per_s=round(len(edges) * cfg["iters"] / warm * 1e3),
           busy_ms=busy, busy_wall_ms=round(busy_wall, 1),
           warm_to_host_ms=round(to_host[1], 1), max_rel_err_oracle=err,
           max_rel_diff_kernels_off=err_off, launches=launches, **calls,
           spark_graph=list(cfg["spark"]), **spark)


def tc_oracle(edges, n_vertices, max_rounds):
    """The closure ``transitive_closure`` computes: pairs as sorted int64
    codes ``a * V + b``, extended by one edge a round until nothing changes
    or ``max_rounds`` rounds; (codes, rounds)."""
    import numpy as np

    src, dst = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
    order = np.argsort(src, kind="stable")
    s_src, s_dst = src[order], dst[order]
    ids = np.arange(n_vertices)
    lo, hi = np.searchsorted(s_src, ids), np.searchsorted(s_src, ids, "right")
    codes = np.unique(src * n_vertices + dst)
    old, rounds = 0, 0
    while len(codes) != old and rounds < max_rounds:
        old = len(codes)
        x, y = codes // n_vertices, codes % n_vertices
        cnt = hi[y] - lo[y]
        at = np.repeat(lo[y] - (np.cumsum(cnt) - cnt), cnt) + np.arange(cnt.sum())
        codes = np.unique(np.concatenate([codes, np.repeat(x, cnt) * n_vertices + s_dst[at]]))
        rounds += 1
    return codes, rounds


def _tc_codes(tc, n_vertices):
    import numpy as np

    a, b = _valid_rows(tc)
    return np.sort(a.astype(np.int64) * n_vertices + b)


def app_tc():
    import numpy as np

    from repro_torch.apps.graph import make_graph, transitive_closure

    cfg = APPS["tc"]
    start_app()
    # the cut: at 2^18 vertices the default packing of distinct keys collides
    big_v, big_e = cfg["packed_check"]
    codes, _ = tc_oracle(make_graph(big_v, big_e, seed=3), big_v, cfg["rounds"])
    a, b = (codes // big_v).astype(np.int32), (codes % big_v).astype(np.int32)
    shared = len(codes) - len(np.unique((a << 16) | (b & 0xFFFF)))
    log(f"apps: tc: at {big_v} vertices, {big_e} edges the closure after {cfg['rounds']} rounds "
        f"has {len(codes)} pairs, of which {shared} share a packed distinct key with another "
        f"(so the phase runs {cfg['vertices']} vertices)")
    del codes, a, b
    nv = cfg["vertices"]
    edges = make_graph(nv, cfg["edges"], seed=3)
    want, rounds = tc_oracle(edges, nv, cfg["rounds"])
    w = app_worker()

    def run(w, e=edges):
        return transitive_closure(w, e, max_rounds=cfg["rounds"], max_matches=cfg["matches"])

    _, cold = timed(lambda: run(w))
    start_app()
    tc, warm = timed(lambda: run(w))
    launches = app_launches("tc", must=("bucket_route",))
    routed = ROUTE_CALLS["path"]
    busy_wall, busy = device_busy_ms(lambda: run(w))
    got = _tc_codes(tc, nv)
    check(np.array_equal(got, want),
          f"apps: tc: {len(got)} pairs against the oracle's {len(want)} (or other pairs)")
    no_fallback("tc", w)
    sv, se = cfg["spark"]
    small = make_graph(sv, se, seed=3)
    swant, _ = tc_oracle(small, sv, cfg["rounds"])
    out, spark = spark_ratio(lambda w: _tc_codes(run(w, small), sv), "tc")
    for mode, got_s in out.items():
        check(np.array_equal(got_s, swant), f"apps: tc ({mode}, small) differs from the oracle")
    report("tc", vertices=nv, edges=len(edges), rounds=rounds, pairs=len(got),
           packed_key_collisions_at_2_18=shared, cold_ms=round(cold, 1), wall_ms=round(warm, 1),
           pairs_per_s=round(len(got) / warm * 1e3), busy_ms=busy,
           busy_wall_ms=round(busy_wall, 1), launches=launches, routed_exchanges=routed,
           spark_graph=[sv, se], **spark)


def kmeans_oracle_step(pts, centres):
    """One float64 K-Means step from ``centres`` in numpy (distances by the
    ‖p‖² - 2p·c + ‖c‖² expansion, sums by a one-hot product): (new
    centres, the assignment it made)."""
    import numpy as np

    p = pts.astype(np.float64)
    c = centres.astype(np.float64)
    asg = np.argmin((p * p).sum(1)[:, None] - 2 * p @ c.T + (c * c).sum(1)[None], axis=1)
    oh = np.zeros((len(p), len(c)))
    oh[np.arange(len(p)), asg] = 1.0
    return (oh.T @ p) / np.maximum(oh.sum(0), 1.0)[:, None], asg


def app_kmeans():
    import numpy as np
    import torch

    from repro_torch.apps.kmeans import (_assign, kmeans_driver_eval, kmeans_on_device,
                                         make_points)

    cfg = APPS["kmeans"]
    start_app()
    n, k = cfg["n"], cfg["k"]
    pts, _ = make_points(n, cfg["d"], k, seed=0)
    init = pts[np.random.default_rng(0).choice(n, k, replace=False)]
    dev = torch.device(APP_DEVICE)
    p_dev, c0 = torch.from_numpy(pts).to(dev), torch.from_numpy(init).to(dev)
    _, cold = timed(lambda: kmeans_on_device(p_dev, c0, cfg["iters"]))
    torch.cuda.reset_peak_memory_stats()
    on_dev, warm = timed(lambda: kmeans_on_device(p_dev, c0, cfg["iters"]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    busy_wall, busy = device_busy_ms(lambda: kmeans_on_device(p_dev, c0, cfg["iters"]))
    drv, drv_ms = timed(lambda: kmeans_driver_eval(p_dev, init, cfg["iters"]))
    check(torch.equal(_assign(p_dev, on_dev), _assign(p_dev, drv)),
          "apps: kmeans: on-device and driver-evaluated assignments differ")
    d_err = max_err(on_dev, drv)
    check(d_err <= KMEANS_ATOL, f"apps: kmeans: on-device against driver centres {d_err}")
    # the last step against float64 numpy from the device's centres before it
    # (a float64 loop from the start drifts from f32's at near-tied points,
    # and each of its 20 steps costs seconds of host time)
    before = kmeans_on_device(p_dev, c0, cfg["iters"] - 1)
    want, want_asg = kmeans_oracle_step(pts, before.cpu().numpy())
    o_err = float(np.abs(on_dev.cpu().numpy() - want).max())
    moved = int((_assign(p_dev, before).cpu().numpy() != want_asg).sum())
    check(o_err <= KMEANS_ATOL,
          f"apps: kmeans: centres {o_err} from the float64 step ({moved} points assigned "
          f"otherwise)")
    w = app_worker(kind="cpp")
    w.load_library("repro_torch.apps.kmeans")
    df = w.parallelize(p_dev)
    (cn,), call_ms = timed(lambda: _valid_rows(
        w.call("kmeans_mpi", df, iters=cfg["iters"], k=k, seed=0)))
    check(cn.shape == (k, cfg["d"]) and bool(np.isfinite(cn).all()),
          f"apps: kmeans_mpi gave centres of shape {cn.shape}, or non-finite ones")
    no_fallback("kmeans", w)
    report("kmeans", points=n, d=cfg["d"], k=k, iters=cfg["iters"], cold_ms=round(cold, 1),
           wall_ms=round(warm, 1), point_iters_per_s=round(n * cfg["iters"] / warm * 1e3),
           busy_ms=busy, busy_wall_ms=round(busy_wall, 1), loop_peak_gib=round(peak, 3),
           max_abs_diff_driver=d_err, max_abs_err_oracle=o_err,
           points_assigned_otherwise_than_oracle=moved, kmeans_mpi_ms=round(call_ms, 1),
           launches=app_launches("kmeans"), ignis_ms=round(warm, 1),
           spark_ms=round(drv_ms, 1), spark_over_ignis=round(drv_ms / warm, 2))


def sha256_compress_np(w):
    """The SHA-256 compression of one 16-word chunk from H0, in numpy
    uint32 (a host implementation apart from the port's): (..., 16) →
    (..., 8)."""
    import numpy as np

    with np.errstate(over="ignore"):  # uint32 adds wrap, as SHA-256's do
        return _sha256_compress_np(w)


def _sha256_compress_np(w):
    import numpy as np

    from repro_torch.apps.sha256 import _H0, _K

    def rotr(x, n):
        return (x >> np.uint32(n)) | (x << np.uint32(32 - n))

    w = [w[..., i].astype(np.uint32) for i in range(16)]
    for i in range(16, 64):
        a, b = w[i - 15], w[i - 2]
        w.append(w[i - 16] + (rotr(a, 7) ^ rotr(a, 18) ^ (a >> np.uint32(3))) + w[i - 7]
                 + (rotr(b, 17) ^ rotr(b, 19) ^ (b >> np.uint32(10))))
    st = [np.full(w[0].shape, h, np.uint32) for h in _H0]
    for i in range(64):
        a, b, c, d, e, f, g, h = st
        t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + ((e & f) ^ (~e & g)) + _K[i] + w[i]
        t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c))
        st = [t1 + t2, a, b, c, d + t1, e, f, g]
    return np.stack(st, -1) + _H0


def _anchor_sha_to_hashlib():
    """The host compression, on messages padded as SHA-256 pads them, is
    hashlib.sha256."""
    import hashlib

    import numpy as np

    for msg in (b"", b"abc", b"a" * 55, bytes(range(36))):
        buf = np.zeros(64, np.uint8)
        buf[: len(msg)] = np.frombuffer(msg, np.uint8)
        buf[len(msg)] = 0x80
        buf[-8:] = np.frombuffer((len(msg) * 8).to_bytes(8, "big"), np.uint8)
        words = buf.reshape(16, 4).astype(np.uint32)
        words = (words[:, 0] << 24) | (words[:, 1] << 16) | (words[:, 2] << 8) | words[:, 3]
        d = sha256_compress_np(words)
        check(b"".join(int(x).to_bytes(4, "big") for x in d).hex()
              == hashlib.sha256(msg).hexdigest(),
              f"apps: minebench: the host SHA-256 differs from hashlib on {msg!r}")


def minebench_oracle(blocks, iters, bits):
    """Merkle roots and (first nonce under the target, found) per block, on
    the host."""
    import numpy as np

    h = sha256_compress_np(blocks)
    while h.shape[-2] > 1:
        if h.shape[-2] % 2:
            h = np.concatenate([h, h[..., -1:, :]], axis=-2)
        h = sha256_compress_np(np.concatenate([h[..., 0::2, :], h[..., 1::2, :]], -1))
    roots = h[..., 0, :]
    hdr = np.zeros((len(roots), iters, 16), np.uint32)
    hdr[..., :8] = roots[:, None]
    hdr[..., 8] = np.arange(iters, dtype=np.uint32)
    hdr[..., 15] = 36 * 8
    hit = sha256_compress_np(hdr)[..., 0] < (1 << (32 - bits))
    found = hit.any(1)
    return roots, np.where(found, hit.argmax(1), 0).astype(np.uint32), found


def app_minebench():
    import numpy as np

    from repro_torch.apps.minebench import make_blocks, make_map2_fn, map1_fn
    from repro_torch.core import IWorker

    cfg = APPS["minebench"]
    start_app()
    _anchor_sha_to_hashlib()
    blocks = make_blocks(cfg["blocks"], cfg["txs"], seed=0)
    map2 = make_map2_fn(cfg["iters"], cfg["bits"])

    def single(w, b=blocks):
        return _valid_rows(w.parallelize(b).map(map1_fn).map(map2))

    def multi(w1, b=blocks):
        w2 = IWorker(w1.cluster, "cpp")
        roots = w1.parallelize(b).map(map1_fn).cache()
        return _valid_rows(roots), _valid_rows(w2.import_data(roots).map(map2))

    w = app_worker()
    _, cold = timed(lambda: single(w))
    (found, nonce), warm = timed(lambda: single(w))
    busy_wall, busy = device_busy_ms(lambda: single(w))
    check(nonce.dtype == np.uint32 and found.dtype == np.bool_,
          f"apps: minebench rows are {nonce.dtype}, {found.dtype}, not uint32, bool")
    ((roots,), (found2, nonce2)), multi_ms = timed(lambda: multi(w))
    check(np.array_equal(nonce, nonce2) and np.array_equal(found, found2),
          "apps: minebench: two workers differ from one")
    pick = np.sort(np.random.default_rng(1).choice(cfg["blocks"], cfg["sample"], replace=False))
    r_want, n_want, f_want = minebench_oracle(blocks[pick], cfg["iters"], cfg["bits"])
    check(np.array_equal(roots[pick], r_want), "apps: minebench roots differ from the host's")
    check(np.array_equal(nonce[pick], n_want) and np.array_equal(found[pick], f_want),
          "apps: minebench (nonce, found) differ from the host's")
    no_fallback("minebench", w)
    small = blocks[: cfg["spark_blocks"]]
    out, spark = spark_ratio(lambda w: single(w, small), "minebench")
    out2, spark2 = spark_ratio(lambda w: multi(w, small)[1], "minebench two workers",
                               prefix="two_workers_")
    for got in (out["spark"], out2["ignis"], out2["spark"]):
        check(all(np.array_equal(a, b) for a, b in zip(got, out["ignis"])),
              "apps: minebench (small): the modes or variants differ")
    report("minebench", blocks=cfg["blocks"], txs=cfg["txs"], nonces=cfg["iters"],
           difficulty_bits=cfg["bits"], found=int(found.sum()), cold_ms=round(cold, 1),
           wall_ms=round(warm, 1), blocks_per_s=round(cfg["blocks"] / warm * 1e3),
           two_workers_ms=round(multi_ms, 1), busy_ms=busy, busy_wall_ms=round(busy_wall, 1),
           sampled=cfg["sample"], spark_blocks=cfg["spark_blocks"], **spark, **spark2)


def _native_pair(w, app, native, x, iters):
    """The native program and ``worker.call`` of its wrapped form: their
    results (equal bit for bit), each one's cold ms, and each one's median
    warm ms over three calls taken in turns (N F F N N F); every warm call
    is a plan-cache hit and builds nothing."""
    import torch

    from repro_torch.core import comm

    ranks, axis = w.context.comm()
    df = w.parallelize(x)
    fns = {"native": lambda: native(ranks, axis, x, iters),
           "framework": lambda: w.call(app, df, iters=iters)._blocks()[0].data}
    res, ms, warm = {}, {}, {"native": [], "framework": []}
    for label, fn in fns.items():
        _, ms[f"{label}_cold"] = timed(fn)
    for label in ("native", "framework", "framework", "native", "native", "framework"):
        before = comm.comm_stats()
        res[label], t = timed(fns[label])
        after = comm.comm_stats()
        warm[label].append(t)
        hits = after["coll_plan_hits"] - before["coll_plan_hits"]
        misses = after["coll_plan_misses"] - before["coll_plan_misses"]
        check(hits == 1 and misses == 0,
              f"apps: {app} ({label}) warm call: {hits} plan hits, {misses} misses")
    check(torch.equal(res["native"], res["framework"]),
          f"apps: {app}: worker.call differs from the native program")
    ms.update({label: sorted(v)[1] for label, v in warm.items()})
    return res["native"], ms


def app_stencil():
    import numpy as np
    import torch

    from repro_torch.apps.stencil import stencil_native

    cfg = APPS["stencil"]
    start_app()
    w = app_worker(kind="cpp")
    w.load_library("repro_torch.apps.stencil")
    g = torch.Generator(device=APP_DEVICE).manual_seed(0)
    grid = torch.randn((cfg["rows"], cfg["cols"]), generator=g, device=APP_DEVICE)
    out, ms = _native_pair(w, "stencil_app", stencil_native, grid, cfg["iters"])
    check(bool(torch.isfinite(out).all()), "apps: stencil: a cell is not finite")
    busy_wall, busy = device_busy_ms(lambda: stencil_native(*w.context.comm(), grid, cfg["iters"]))
    ranks, axis = w.context.comm()
    got = stencil_native(ranks, axis, grid, cfg["check_iters"]).cpu().numpy()
    u = grid.cpu().numpy()
    for _ in range(cfg["check_iters"]):
        u = (np.roll(u, 1, 0) + np.roll(u, -1, 0) + np.roll(u, 1, 1) + np.roll(u, -1, 1)) * 0.25
    err = float(np.abs(got - u).max())
    check(err <= STENCIL_ATOL, f"apps: stencil: {err} from the numpy periodic Jacobi")
    cells = cfg["rows"] * cfg["cols"] * cfg["iters"]
    report("stencil", grid=[cfg["rows"], cfg["cols"]], iters=cfg["iters"],
           native_cold_ms=round(ms["native_cold"], 1), wall_ms=round(ms["native"], 1),
           framework_cold_ms=round(ms["framework_cold"], 1), framework_ms=round(ms["framework"], 1),
           overhead_pct=round((ms["framework"] - ms["native"]) / ms["native"] * 100, 2),
           cell_iters_per_s=round(cells / ms["native"] * 1e3), busy_ms=busy,
           busy_wall_ms=round(busy_wall, 1), max_abs_err_numpy=err)


def cg_oracle(b, iters):
    """float64 CG on the 1-D Laplacian with Dirichlet ends, in numpy."""
    import numpy as np

    b = b.astype(np.float64)
    x, r = np.zeros_like(b), b.copy()
    q, rs, aq = r.copy(), r @ r, np.empty_like(b)
    for _ in range(iters):
        np.multiply(q, 2, out=aq)
        aq[:-1] -= q[1:]
        aq[1:] -= q[:-1]
        alpha = rs / max(q @ aq, 1e-30)
        x += alpha * q
        r -= alpha * aq
        rs_new = r @ r
        q *= rs_new / max(rs, 1e-30)
        q += r
        rs = rs_new
    return x


def app_cg():
    import numpy as np
    import torch

    from repro_torch.apps.stencil import cg_native

    cfg = APPS["cg"]
    start_app()
    w = app_worker(kind="cpp")
    w.load_library("repro_torch.apps.stencil")
    b = np.random.default_rng(1).normal(size=cfg["n"]).astype(np.float32)
    bt = torch.from_numpy(b).to(APP_DEVICE)
    x, ms = _native_pair(w, "cg_app", cg_native, bt, cfg["iters"])
    busy_wall, busy = device_busy_ms(lambda: cg_native(*w.context.comm(), bt, cfg["iters"]))
    want = cg_oracle(b, cfg["iters"])
    err = float(np.linalg.norm(x.cpu().numpy() - want) / np.linalg.norm(want))
    check(err <= CG_REL_L2, f"apps: cg: relative L2 {err} from numpy's float64 CG")
    report("cg", rows=cfg["n"], iters=cfg["iters"], native_cold_ms=round(ms["native_cold"], 1),
           wall_ms=round(ms["native"], 1), framework_cold_ms=round(ms["framework_cold"], 1),
           framework_ms=round(ms["framework"], 1),
           overhead_pct=round((ms["framework"] - ms["native"]) / ms["native"] * 100, 2),
           row_iters_per_s=round(cfg["n"] * cfg["iters"] / ms["native"] * 1e3), busy_ms=busy,
           busy_wall_ms=round(busy_wall, 1), rel_l2_numpy=err)


def apps_phase():
    """The paper's evaluation apps on ``p = 8`` virtual ranks through the
    port's entry points, each at full size in ignis mode and against the
    spark-mode baseline at a shared size; every check fails the run."""
    import torch

    from repro_torch.core import IWorker

    pipe_block = IWorker._pipe_block

    def timed_pipe(self, b):
        t0 = time.perf_counter()
        out = pipe_block(self, b)
        PIPE.add(t0, time.perf_counter())
        return out

    IWorker._pipe_block = timed_pipe
    t0 = time.perf_counter()
    start_app()
    log(f"apps: start with {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    for app in (app_terasort, app_pagerank, app_tc, app_kmeans, app_minebench, app_stencil,
                app_cg):
        t = time.perf_counter()
        app()
        log(f"apps: {app.__name__[4:]} phase took {time.perf_counter() - t:.1f} s")
    IWorker._pipe_block = pipe_block
    start_app()
    log(f"apps: all passed in {time.perf_counter() - t0:.1f} s, leaving "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; "
        f"summary {json.dumps(APP_REPORT)}")


# ---------------------------------------------------------------------------
# the recovery tier: checkpoint and repair, chaos, the elastic mesh and
# streaming ingestion on the card
# ---------------------------------------------------------------------------

#: the recovery phase's sizes (only a rehearsal on the CPU changes them): the
#: hybrid path's 2^26 (key, value) int32 rows; 4 stream tenants of 2^18 rows
#: x 8 int32 columns in 4096-row batches, an offset checkpoint every 8
RECOVERY = dict(n=1 << 26, blocks=8, vocab=1 << 20, tenants=4, stream_rows=1 << 18,
                stream_cols=8, batch_rows=4096, ckpt_interval=8, kill_batch=5,
                restart_after=40)
RECOVERY_REPORT: dict = {}


def recovery_worker(p=8, **props):
    from repro_torch.core import ICluster, IProperties, IWorker

    return IWorker(ICluster(IProperties({
        "ignis.device": APP_DEVICE, "ignis.executor.instances": str(p),
        **{k: str(v) for k, v in props.items()}}), slots=8), "python")


def _retries():
    from repro_torch.core.job import default_scheduler

    return default_scheduler().stats["task_retries"]


def _kv_sorted(df):
    """A ``{key, value}`` frame's valid rows, read from its blocks, sorted
    by key (every leaf in that order). The blocks come from an action on
    the job scheduler, so that a task fault retries as in ``collect``."""
    import numpy as np

    cols = _block_rows(df._submit("blocks", blocks_fn=list).result())
    order = np.argsort(cols[0], kind="stable")
    return [c[order] for c in cols]


def _same_cols(a, b) -> bool:
    import numpy as np

    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def _dir_bytes(d) -> int:
    return sum(os.path.getsize(os.path.join(r, f)) for r, _ds, fs in os.walk(d) for f in fs)


def recovery_data():
    """The hybrid path's rows: zipf(1.1) keys mod 2^20 and small int32
    values, so that a key's sum stays exact in int32 (and in numpy's
    float64 bincount), as (N, 2) pairs the frames split into blocks; with
    the per-key oracle and a dimension table."""
    import numpy as np

    cfg = RECOVERY
    rng = np.random.default_rng(0)
    keys = (rng.zipf(1.1, cfg["n"]) % cfg["vocab"]).astype(np.int32)
    vals = rng.integers(0, 16, cfg["n"], dtype=np.int32)
    sums = np.bincount(keys, weights=vals, minlength=cfg["vocab"])
    nz = np.nonzero(np.bincount(keys, minlength=cfg["vocab"]))[0]
    dim_keys = np.arange(cfg["vocab"], dtype=np.int32)
    dim_vals = ((dim_keys.astype(np.int64) * 2654435761) % 1000003).astype(np.int32)
    return dict(keys=keys, vals=vals, pairs=np.stack([keys, vals], axis=1),
                rbk=[nz.astype(np.int32), sums[nz].astype(np.int32)],
                dim={"key": dim_keys, "value": dim_vals},
                join=[nz.astype(np.int32), sums[nz].astype(np.int32), dim_vals[nz]])


def _rbk(df):
    return df.reduce_by_key(lambda a, b: a + b, 0)


def recovery_checkpoint(data, root):
    """Checkpoint the rows, lose a rank's block and then every block, and
    read them back from disk; a corrupt leaf must raise."""
    import torch

    cfg = RECOVERY
    w = recovery_worker()
    src = w.parallelize(data["pairs"], blocks=cfg["blocks"])
    frame = src.map(lambda r: {"key": r[0], "value": r[1]})
    d = os.path.join(root, "frame")
    ck, save_ms = timed(lambda: frame.checkpoint(d))
    disk = _dir_bytes(d)
    check(ck.node.parents == [] and len(ck.node.result) == cfg["blocks"],
          "recovery: checkpoint did not truncate the lineage into its blocks")
    src_cc = src.node.compute_count
    base = dict(w.metrics("stages"))
    lost = w.kill_executor(3)
    check(ck.node.result[3] is None and lost >= 2,
          f"recovery: kill_executor(3) lost {lost} blocks, the checkpoint's block 3 kept")
    got, rbk_ms = timed(lambda: _kv_sorted(_rbk(ck)))
    st = w.metrics("stages")
    restores = st["block_restores"] - base["block_restores"]
    check(_same_cols(got, data["rbk"]), "recovery: reduceByKey after kill_executor(3) "
          "differs from numpy")
    check(restores == 1 and st["block_recomputes"] == base["block_recomputes"],
          f"recovery: {restores} block restores, "
          f"{st['block_recomputes'] - base['block_recomputes']} recomputes after one lost rank")
    check(src.node.compute_count == src_cc, "recovery: the source was read again")
    check(ck.node.result[3].device == w.device and ck.node.result[3].ranks == w.context.ranks,
          "recovery: the restored block is not on the worker's device and ranks")
    w.restore_executor(3)
    for r in range(cfg["blocks"]):
        w.kill_executor(r, blacklist=False)
    base = w.metrics("stages")["block_restores"]
    n, restore_ms = timed(ck.count)
    check(n == cfg["n"] and w.metrics("stages")["block_restores"] - base == cfg["blocks"],
          f"recovery: restoring every block counted {n} rows, "
          f"{w.metrics('stages')['block_restores'] - base} restores")
    check(_same_cols(_kv_sorted(_rbk(ck)), data["rbk"]),
          "recovery: reduceByKey after the full restore differs from numpy")
    # chaos on the card, each with the retry count the CPU suite asserts
    chaos = {}
    from repro_torch.core import faults

    def chaos_run(name, run, plan, want):
        r0 = _retries()
        with faults.inject(plan):
            got = run()
        retries, inj = _retries() - r0, plan.injections()
        check(retries == 1 and inj == 1, f"recovery: {name}: {retries} retries, {inj} "
              "injections, not 1 and 1")
        check(_same_cols(got, want) if isinstance(want, list) else got == want,
              f"recovery: {name}: the faulted run differs from its oracle")
        chaos[name] = dict(retries=retries, injections=inj)

    chaos_run("kernel.stage kill in reduceByKey", lambda: _kv_sorted(_rbk(ck)),
              faults.FaultPlan().fail_kernel_stage("reduceByKey"), data["rbk"])
    fused = (ck.map(lambda r: r["value"] * 3).filter(lambda v: v % 2 == 0)
             .map(lambda v: v + 1))
    check(bool(w.engine.plan(fused.node)), "recovery: the narrow chain did not fuse")
    want = int((data["vals"] % 2 == 0).sum())
    chaos_run("dag.block kill in a fused stage", fused.count,
              faults.FaultPlan().kill_block(op="map", block=2), want)
    dim = w.parallelize(data["dim"])
    joined = _rbk(ck).compact().join(dim)
    chaos_run("collective kill in a join", lambda: _kv_sorted(joined),
              faults.FaultPlan().fail_collective("join"), data["join"])
    check(w.metrics("kernels")["kernel_fallbacks"] == 0, "recovery: a kernel fell back")
    # a corrupt leaf raises on the card as on the CPU
    sdir = os.path.join(d, os.listdir(d)[0])
    victim = sorted(f for f in os.listdir(sdir) if f.endswith(".npy"))[0]
    with open(os.path.join(sdir, victim), "r+b") as f:
        f.seek(200)
        f.write(b"\xde\xad\xbe\xef")
    w.kill_executor(0, blacklist=False)
    try:
        ck.count()
        raise SmokeFailure("recovery: a corrupt checkpoint leaf restored without an error")
    except IOError as e:
        check("corruption" in str(e), f"recovery: the corrupt leaf raised {e!r}")
    torch.cuda.synchronize()
    RECOVERY_REPORT["checkpoint"] = dict(
        rows=cfg["n"], blocks=cfg["blocks"], disk_bytes=disk, save_ms=round(save_ms, 1),
        save_gb_per_s=round(disk / save_ms / 1e6, 3), restore_all_ms=round(restore_ms, 1),
        restore_gb_per_s=round(disk / restore_ms / 1e6, 3), rbk_after_kill_ms=round(rbk_ms, 1),
        chaos=chaos)
    log(f"recovery: checkpoint {RECOVERY_REPORT['checkpoint']}")


def hold_taped_routes(held: dict):
    """Hold each router call on ``ROUTE_TAPE`` against ``bucket_route_ref``
    on its own destinations and capacity, pos, keep and counts bit for bit;
    tally the calls, rows and rows not kept by bucket count into ``held``,
    and empty the tape."""
    from repro_torch.kernels.moe_route.ref import bucket_route_ref

    for dest, P, C, *got in ROUTE_TAPE:
        ref = bucket_route_ref(dest, P, C)
        for a, b, nm in zip(got, ref, ("pos", "keep", "counts")):
            check(same_bits(a, b), f"recovery: the bucket router at P = {P}, C = {C}, "
                  f"{dest.shape[0]} rows: {nm} differs from bucket_route_ref")
        h = held.setdefault(P, dict(calls=0, rows=0, not_kept=0))
        h["calls"] += 1
        h["rows"] += dest.shape[0]
        h["not_kept"] += int((~ref[1]).sum())
    ROUTE_TAPE.clear()


def _cached_blocks(w) -> dict:
    """Each cached block of the worker, by (node, index): its rank set and
    the storage pointer and bytes of each of its tensors."""
    from repro_torch.core import tree

    out = {}
    for node in list(w._cached_nodes):
        for i, b in enumerate(node.result or []):
            if b is not None:
                ts = [*tree.leaves(b.data), b.valid]
                out[id(node), i] = (b.ranks, [(t.data_ptr(), t.nbytes) for t in ts])
    return out


def recovery_elastic(data):
    """The persisted rows at p = 8, the dimension table persisted on the
    first of two groups (ranks 0-3), then shrink(4), grow(2) to 6 and
    grow(2) back to 8: reduceByKey, sort and join (the router at P = p^2,
    each call held against its plain version) equal the static p = 8 run at
    every size; each resize moves every world block and keeps the group's
    while they lie in the new world; then one block lost mid-move."""
    import numpy as np
    import torch

    from repro_torch.core import faults

    w = recovery_worker()
    frame = (w.parallelize(data["pairs"], blocks=RECOVERY["blocks"])
             .map(lambda r: {"key": r[0], "value": r[1]}).persist())
    frame.count()
    group = w.groups(2)[0]
    with w.use_group(group):
        dim = w.parallelize(data["dim"]).persist()
        dim.count()
    dim_blocks = len(dim.node.result)
    check(all(b.ranks == tuple(group.ranks) for b in dim.node.result),
          "recovery: the table persisted on a group is not committed to its ranks")

    def run_all():
        rbk = _kv_sorted(_rbk(frame))
        (keys,) = _valid_rows(frame.map(lambda r: r["key"]).sort())
        join = _kv_sorted(_rbk(frame).compact().join(dim))
        return rbk, keys, join

    held = RECOVERY_REPORT.setdefault("router_held", {})
    SWEEPS.take()
    g0 = w.metrics("shuffle")["group_reshards"]
    static, static_ms = timed(run_all)
    static_reshards = w.metrics("shuffle")["group_reshards"] - g0
    hold_taped_routes(held)
    check(_same_cols(static[0], data["rbk"]), "recovery: p=8 reduceByKey differs from numpy")
    check(np.array_equal(static[1], np.sort(data["keys"])),
          "recovery: p=8 sort differs from np.sort")
    check(_same_cols(static[2], data["join"]), "recovery: p=8 join differs from numpy")
    check(static_reshards == dim_blocks, f"recovery: the p=8 join placed {static_reshards} "
          f"group blocks onto the world, not the table's {dim_blocks}")
    # (resize, ranks, the table's blocks kept): at shrink(4) the group's
    # ranks are the new world; each grow moves them with the world's
    steps = [("shrink", 4, dim_blocks), ("grow", 2, 0), ("grow", 2, 0)]
    sizes = []
    base = dict(w.metrics("elastic"))
    eng0 = w.metrics("stages")["block_recomputes"]
    for op, n, want_kept in steps:
        old = list(w.context.ranks)
        new = old[: len(old) - n] if op == "shrink" else old + [
            r for r in range(w.cluster.slots) if r not in old][:n]
        before = _cached_blocks(w)
        st0 = dict(w.metrics("elastic"))
        p, resize_ms = timed(lambda: getattr(w, op)(n))
        st = w.metrics("elastic")
        after = _cached_blocks(w)
        moves = st["reshard_moves"] - st0["reshard_moves"]
        kept = st["reshard_unchanged"] - st0["reshard_unchanged"]
        check(p == len(new) and list(w.context.ranks) == new,
              f"recovery: {op}({n}) gave world {list(w.context.ranks)}, not {new}")
        # what the resize left: a moved block is committed to the new world,
        # a kept one is the same block with the same ranks
        moved_seen = [k for k in after if after[k][0] != before[k][0]]
        kept_seen = [k for k in after if after[k] == before[k]]
        check(after.keys() == before.keys()
              and all(after[k][0] == tuple(new) for k in moved_seen)
              and len(moved_seen) + len(kept_seen) == len(after),
              f"recovery: {op}({n}) left a cached block neither moved to {new} nor kept")
        check((moves, kept) == (len(moved_seen), len(kept_seen))
              and kept == want_kept and moves == len(after) - want_kept
              and st["reshard_recomputes"] == 0,
              f"recovery: {op}({n}): counted {moves} moves, {kept} kept, "
              f"{st['reshard_recomputes']} recomputes; the blocks show {len(moved_seen)} moved, "
              f"{len(kept_seen)} kept; {len(after) - want_kept} and {want_kept} expected")
        recommitted = sum(nb for k in moved_seen for _ptr, nb in after[k][1])
        copied = sum(nb for k in after for (ptr, nb), (ptr0, _nb) in
                     zip(after[k][1], before[k][1]) if ptr != ptr0)
        del before, after
        SWEEPS.take()
        g0 = w.metrics("shuffle")["group_reshards"]
        got, run_ms = timed(run_all)
        reshards = w.metrics("shuffle")["group_reshards"] - g0
        sweeps = SWEEPS.take()
        hold_taped_routes(held)
        for what, a, b in zip(("reduceByKey", "sort", "join"), got, static):
            same = _same_cols(a, b) if isinstance(a, list) else np.array_equal(a, b)
            check(same, f"recovery: {what} at p={p} differs from the static p=8 run")
        check(p * p in held, f"recovery: no router call at P = {p * p} after {op}({n})")
        check(reshards == 0, f"recovery: at p={p} the join placed {reshards} group blocks")
        sizes.append(dict(op=f"{op}({n})", p=p, buckets=p * p, resize_ms=round(resize_ms, 2),
                          moved_blocks=moves, kept_blocks=kept, recommitted_bytes=recommitted,
                          copied_bytes=copied, actions_ms=round(run_ms, 1),
                          new_key_sweeps=sweeps[0], new_key_sweep_ms=round(sweeps[1], 1)))
        log(f"recovery: elastic {sizes[-1]}")
    check(w.metrics("stages")["block_recomputes"] == eng0,
          "recovery: a clean resize recomputed blocks")
    # one block lost mid-move: a hole, repaired block-wise on the next action
    plan = faults.FaultPlan().fail_elastic_reshard(op="map", block=2)
    with faults.inject(plan):
        w.shrink(2)
    st = w.metrics("elastic")
    check(plan.injections("elastic.reshard") == 1 and st["reshard_recomputes"] == 1
          and frame.node.result[2] is None,
          f"recovery: elastic.reshard fault: {plan.injections('elastic.reshard')} injections, "
          f"{st['reshard_recomputes']} recomputes")
    r0 = _retries()
    check(_same_cols(_kv_sorted(_rbk(frame)), static[0]),
          "recovery: reduceByKey after the lost move differs from the static run")
    check(w.metrics("stages")["block_recomputes"] - eng0 == 1 and _retries() == r0,
          "recovery: the lost block was not repaired block-wise (one recompute, no retry)")
    check(w.metrics("kernels")["kernel_fallbacks"] == 0, "recovery: a kernel fell back")
    torch.cuda.synchronize()
    RECOVERY_REPORT["elastic"] = dict(
        static_p8_actions_ms=round(static_ms, 1), static_group_reshards=static_reshards,
        steps=sizes, totals={k: st[k] - base.get(k, 0) for k in st if k != "world_size"})
    log(f"recovery: elastic totals {RECOVERY_REPORT['elastic']['totals']}")


def recovery_streaming(root):
    """4 tenants on ``worker.groups(4)`` through a TenantFrontEnd; each
    state equals numpy's int64 column sums; then one tenant killed at a
    batch and restarted from its checkpoint, bit identical."""
    import numpy as np

    from repro_torch.core import faults
    from repro_torch.streaming import ArraySource, StreamContext, TenantFrontEnd

    cfg = RECOVERY
    w = recovery_worker(**{"ignis.stream.batch.rows": cfg["batch_rows"],
                           "ignis.stream.checkpoint.interval": cfg["ckpt_interval"]})
    tables = [np.random.default_rng(t).integers(-2**31, 2**31 - 1,
                                                (cfg["stream_rows"], cfg["stream_cols"]),
                                                dtype=np.int32)
              for t in range(cfg["tenants"])]
    oracle = [t.astype(np.int64).sum(axis=0) for t in tables]
    batches = cfg["stream_rows"] // cfg["batch_rows"]
    zeros = np.zeros((cfg["stream_cols"],), np.int64)
    fe = TenantFrontEnd(w, n_groups=cfg["tenants"], name="recovery")
    for t in range(cfg["tenants"]):
        fe.admit(f"t{t}", ArraySource(tables[t]), init_state=zeros,
                 ckpt_dir=os.path.join(root, f"stream-t{t}"))
    res, ms = timed(fe.run)
    snap = fe.telemetry.snapshot(fe.admission)
    tenants = {}
    for t in range(cfg["tenants"]):
        name = f"t{t}"
        check(np.array_equal(res[name], oracle[t]),
              f"recovery: tenant {name}'s state differs from numpy's column sums")
        sc = fe.stream(name)
        check(sc.committed == batches and sc.offset == cfg["stream_rows"],
              f"recovery: tenant {name} committed {sc.committed} batches to {sc.offset}")
        lat = fe.telemetry._tenants[name].latencies_ms
        tenants[name] = dict(batches=sc.committed, latency_p50_ms=round(float(np.median(lat)), 2),
                             latency_max_ms=round(max(lat), 2),
                             group=list(sc.group.ranks))
    # one tenant again: a kill at a batch (replayed once), a stop after a
    # number of batches and a restart from its checkpoint dir
    d = os.path.join(root, "stream-restart")

    def pump():
        return StreamContext(w, ArraySource(tables[0]), tenant="r", group=w.groups(4)[0],
                             init_state=zeros, ckpt_dir=d)

    r0 = _retries()
    plan = faults.FaultPlan().fail_stream_batch(tenant="r", batch=cfg["kill_batch"])
    with faults.inject(plan):
        sc1 = pump()
        sc1.run(max_batches=cfg["restart_after"])
    check(plan.injections("stream.batch") == 1 and _retries() - r0 == 1
          and sc1.batches_replayed == 1 and sc1.committed == cfg["restart_after"],
          f"recovery: stream kill: {plan.injections('stream.batch')} injections, "
          f"{_retries() - r0} retries, {sc1.batches_replayed} replayed, {sc1.committed} committed")
    sc2 = pump()
    state = sc2.run()
    check(sc2.restored_from == cfg["restart_after"] and np.array_equal(state, oracle[0])
          and sc2.batches_replayed == 1 and sc2.committed == batches,
          f"recovery: stream restart from {sc2.restored_from}: state equal "
          f"{np.array_equal(state, oracle[0])}, {sc2.batches_replayed} replayed, "
          f"{sc2.committed} committed")
    RECOVERY_REPORT["streaming"] = dict(
        tenants=cfg["tenants"], rows_per_tenant=cfg["stream_rows"], cols=cfg["stream_cols"],
        batch_rows=cfg["batch_rows"], wall_ms=round(ms, 1),
        batches_per_s=round(cfg["tenants"] * batches / ms * 1e3, 1),
        completed=snap["completed"], per_tenant=tenants,
        restart=dict(restored_from=sc2.restored_from, batches_replayed=sc2.batches_replayed))
    log(f"recovery: streaming {RECOVERY_REPORT['streaming']}")


def recovery_phase():
    """The recovery tier on ``p = 8`` virtual ranks of the card: checkpoint
    and repair with chaos, the elastic mesh, streaming ingestion. The
    hybrid kernels' launch counts are zeroed before and read after; every
    check fails the run."""
    import shutil
    import tempfile

    import torch

    global ROUTE_TAPE

    t0 = time.perf_counter()
    start_app()
    data = recovery_data()
    log(f"recovery: {RECOVERY['n']} rows made in {time.perf_counter() - t0:.1f} s")
    root = tempfile.mkdtemp(prefix="recovery-")
    held = RECOVERY_REPORT["router_held"] = {}
    try:
        start_app()
        ROUTE_TAPE = []
        for part in (lambda: recovery_checkpoint(data, root), lambda: recovery_elastic(data),
                     lambda: recovery_streaming(root)):
            t = time.perf_counter()
            part()
            hold_taped_routes(held)
            log(f"recovery: part took {time.perf_counter() - t:.1f} s")
        launches = app_launches("recovery", must=HYBRID_KERNELS)
        RECOVERY_REPORT["launches"] = launches
        check(sum(h["calls"] for h in held.values()) == ROUTE_CALLS["path"],
              f"recovery: {ROUTE_CALLS['path']} routed exchanges, "
              f"{sum(h['calls'] for h in held.values())} held against bucket_route_ref")
        check({16, 36, 64} <= held.keys(), f"recovery: the router ran at P {sorted(held)}")
        log(f"recovery: every router call held bit for bit against bucket_route_ref, by P: "
            f"{json.dumps(held)}")
    finally:
        ROUTE_TAPE = None
        shutil.rmtree(root, ignore_errors=True)
    del data
    start_app()
    log(f"recovery: all passed in {time.perf_counter() - t0:.1f} s, leaving "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; launches {launches}; "
        f"summary {json.dumps(RECOVERY_REPORT)}")
    return launches


# ---------------------------------------------------------------------------
# the serve path: Qwen3-14B through ServeFrontDoor, flash attention in prefill
# ---------------------------------------------------------------------------

#: flash kernel against its plain version: in bf16 the fma route keeps P in
#: f32 where the plain version rounds it to bf16 before P·V, the wgmma route
#: rounds P as the plain version does but sums in another order, and both
#: round the output to bf16 (2^-8 relative), so bf16 is held to 2e-2; f32
#: differs only in summation order (FMA loop against cuBLAS in full f32)
FLASH_TOL = {"torch.bfloat16": (2e-2, 2e-2), "torch.float32": (2e-5, 1e-4)}
#: and in bf16, beside that elementwise test, the relative L2 of (kernel -
#: plain) against the plain output: over some 1800 keys an output element
#: is about 0.04, so the absolute 2e-2 alone would pass a tile summed wrong;
#: the roundings above give a few 1e-3
FLASH_BF16_REL_L2 = 1e-2
#: relative L2 between flash and chunked prefill logits through 40 bf16
#: layers: the paths differ in where P is rounded (above) and in summation
#: order, about one bf16 rounding (2^-9 relative) of each layer's attention
#: output, which the 40 random-weight layers carry and compound
SERVE_REL_L2 = 5e-2
#: relative L2 between Mamba2-780M's prefill logits through the SSD kernel and
#: through ``ssd_chunked``, in an f32 copy of the served weights. In f32 the 48
#: random-weight layers carry a relative change of 1e-6 in every SSD output
#: to 1.1e-5 in the logits (tests/test_torch_ssm.py::
#: test_full_depth_random_stack_amplifies_bf16_roundings_only, reduced width),
#: and the kernel differs from ``ssd_chunked`` in summation order only, so
#: 1e-3 is some 100 times what that predicts. In bf16 the same change moves
#: the logits 6.5e-2, as the bf16 roundings it flips compound: the bf16
#: model's logits are reported, not held, and its SSD kernel is held layer by
#: layer at each layer's own inputs (``SSD_TOL``)
SSM_F32_REL_L2 = 1e-3
#: relative L2 between the router kernel's and its plain version's prefill
#: logits: the two route identically (expert ids and ordinals are held bit
#: for bit by the ``cuda`` tests) and their weights differ in the last bits, so
#: the logits differ only by summation order
MOE_REL_L2 = 1e-2
SERVE_SLOTS, SERVE_CACHE_LEN, SERVE_REQUESTS, SERVE_NEW = 4, 4096, 8, 32
#: the route every launch of a serve path must take, for a kernel with more
#: than one (``launches_by_variant``): bf16 flash on the tensor cores; the
#: decode kernel split over each slot's rows (4 slots leave most SMs
#: without a (slot, kv head) block)
PATH_VARIANT = {"flash_attention": "wgmma", "decode_attention": "split"}
#: the decode kernel against its plain version, elementwise (atol, rtol):
#: its output is bf16; the plain version rounds each probability to bf16
#: before P·V where the kernel keeps it in f32, both round the output to
#: bf16 (2^-9 relative each) and sum in other orders; the flash kernel's
#: bf16 tolerance holds that
DECODE_TOL = (2e-2, 2e-2)
#: and in relative L2 over the output (a row summed wrong would pass the
#: elementwise test): those roundings give a few 1e-3
DECODE_REL_L2 = 1e-2
#: the serve cell's decode (chipbench's olmo-1b.serve-chat-128): 128 slots of
#: 2048 positions, OLMo-1B's 16 kv heads of 128, G = 1, bf16; its mix's laws
#: (chipbench/traffic/serve-chat-128.json): lognormal prompts (median, sigma,
#: min, max) and outputs
DECODE_CELL = dict(slots=128, cache_len=2048, kv_heads=16, group=1, head_dim=128)
DECODE_MIX = dict(prompt=(1020, 0.8, 128, 1792), output=(129, 0.6, 32, 256))
#: each redesigned kernel's time at its row's shape in its earlier design, as
#: recorded on an NVIDIA H100 80GB HBM3 at a 700 W power limit (flash and the
#: SSD scan: their f32-FMA designs, by this script; the segmented scan and
#: the router: their Triton two-pass and one-block designs, by
#: tools/time_lookback_kernels.py, CUDA events and torch.profiler device
#: time respectively; the prefix scan and the bucket router: their Triton
#: designs, by this script, CUDA events); logged beside the new time for a
#: reader, never measured here and never put in the kernels line
RECORDED_EARLIER_MS = {"flash_attention": 1.6673, "ssd_scan": 1.6210,
                       "segment_reduce": 0.9309, "moe_route": 0.0266,
                       "prefix_scan": 0.7313, "bucket_route": 0.1814}
#: Mixtral-8x7B's layers served: all 32 are 46.7e9 parameters, 93.4 GB in
#: bf16, above the card's 80 GB; 24 are 35.1e9 (65.6 GiB)
MIXTRAL_LAYERS = 24
#: Phi-3.5-MoE's layers served: all 32 are 41.9e9 parameters, 83.7 GB in
#: bf16, which with the 4096-position KV slab do not fit the card's 80 GB;
#: 24 are 31.5e9 (62.9 GB), the cut Mixtral takes
PHI_LAYERS = 24


def flash_flop(q_shape, k_shape, causal, q_offset):
    """FLOP of the two products over the live (row, column) pairs, counted
    here; the kernel module's pricing helper (``live_pairs``, which
    ``price_fn`` reads) must give the same."""
    from repro_torch.kernels.flash_attention.flash_attention import live_pairs

    B, H, Sq, hd = q_shape
    Skv = k_shape[2]
    if causal:  # row i sees columns 0 .. i + q_offset (capped at Skv)
        rows = sum(min(i + q_offset + 1, Skv) for i in range(Sq))
    else:
        rows = Sq * Skv
    priced = live_pairs(Sq, Skv, causal, None, q_offset)
    check(priced == rows, f"flash: live_pairs gives {priced} pairs, the smoke counts {rows}")
    return 4 * hd * B * H * rows


SSD_TOL = {  # (atol, rtol) of the SSD kernel against ssd_chunked in f32
    # the JAX kernel test's: the cumulative decays and the chunk products
    # are summed in other orders, and exp of a cumulative sum carries that
    "torch.float32": (2e-4, 1e-3),
    # bf16 inputs: the plain version runs on the same values in f32, and the
    # kernel's y adds one bf16 rounding (2^-9 relative) on top
    "torch.bfloat16": (1e-3, 5e-3),
}
MOE_W_ATOL = 1e-6  # router weights: ratios of the same exps, summed in one order


def _ssd_inputs(g, B, S, H, P, G, N, dtype):
    """The JAX kernel test's distributions: x ~ N(0, 1), dt = softplus of
    N(0, 1), A_log ~ N(0, 0.5), B and C ~ N(0, 0.3)."""
    import torch
    import torch.nn.functional as F

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    x = rnd(B, S, H, P).to(dtype)
    dt = F.softplus(rnd(B, S, H))
    A_log = rnd(H) * 0.5
    Bm, Cm = (rnd(B, S, G, N) * 0.3).to(dtype), (rnd(B, S, G, N) * 0.3).to(dtype)
    return x, dt, A_log, Bm, Cm


def ssd_flop_bytes(x_shape, bn_shape, chunk, itemsize):
    """(operations, bytes) of the SSD scan at these shapes: C·Bᵀ over the
    causal pairs of each (batch, chunk, group), the scores times x·Δ over the
    same pairs, C against the carried state and the state update, per head;
    each input read once and each output written once. The kernel module's
    pricing helper (``work_flops``, which ``price_fn`` reads) must give the
    same operations."""
    from repro_torch.kernels.ssd_scan.ssd_scan import work_flops

    B, S, H, P = x_shape
    G, N = bn_shape[2], bn_shape[3]
    nc, pairs = S // chunk, chunk * (chunk + 1) // 2
    flop = 2 * B * nc * (G * pairs * N + H * (pairs * P + 2 * chunk * N * P))
    priced = work_flops(x_shape, bn_shape, chunk)
    check(priced == flop, f"ssd: work_flops gives {priced}, the smoke counts {flop}")
    nbytes = (2 * B * S * H * P * itemsize + 2 * B * S * G * N * itemsize + B * S * H * 4
              + H * 4 + B * H * P * N * 4)
    return flop, nbytes


def ssd_row(launches, reps: int):
    """The SSD kernel at the Mamba2-780M path's largest prefill, timed beside
    its bound and ``ssd_chunked``; no PyTorch call computes this function."""
    import torch

    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_fwd
    from repro_torch.models.mamba2 import ssd_chunked

    cnt, _t, geoms = launches["ssd_scan"]
    xs, bs, dts, q = max(geoms, key=lambda gm: gm[0][1])
    dt_ = getattr(torch, dts.split(".")[1])
    g = torch.Generator(device="cuda").manual_seed(6)
    x, dt, A_log, Bm, Cm = _ssd_inputs(g, *xs, bs[2], bs[3], dt_)
    y, st = ssd_scan_fwd(x, dt, A_log, Bm, Cm, q)
    yr, sr = ssd_chunked(x.float(), dt, A_log, Bm.float(), Cm.float(), q)
    atol, rtol = SSD_TOL[dts]
    check(torch.allclose(y.float(), yr, atol=atol, rtol=rtol)
          and torch.allclose(st, sr, atol=2e-4, rtol=1e-3),
          f"ssd_scan at {xs}: max abs err y {max_err(y.float(), yr)}, state {max_err(st, sr)}")
    flop, nbytes = ssd_flop_bytes(xs, bs, q, x.element_size())
    t_ops, t_bytes = flop / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    row = dict(
        name="ssd_scan", route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/ssd_scan.py:62", launches=cnt,
        max_abs_err=max(max_err(y.float(), yr), max_err(st, sr)),
        ms=time_ms(lambda: ssd_scan_fwd(x, dt, A_log, Bm, Cm, q), reps),
        plain_ms=time_ms(lambda: ssd_chunked(x, dt, A_log, Bm, Cm, q), max(reps // 4, 2)),
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes", library_ms=None,
        stages_ms=device_ms_by_kernel(lambda: ssd_scan_fwd(x, dt, A_log, Bm, Cm, q)),
        device_ms=device_ms(lambda: ssd_scan_fwd(x, dt, A_log, Bm, Cm, q)),
        shape=[list(xs), list(bs)], dtype=dts, chunk=q, flop=flop, bytes=nbytes)
    log(f"kernel ssd_scan: x {xs} B/C {bs} {dts} chunk {q} launches {cnt} max_abs_err "
        f"{row['max_abs_err']} (against the plain version in f32) | {row['ms']:.4f} ms "
        f"(earlier design {RECORDED_EARLIER_MS['ssd_scan']} ms as recorded, not measured "
        f"here; f32 FMA floor "
        f"{flop / F32_FLOP_PER_S * 1e3:.4f} ms) vs "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: {flop:.3e} FLOP / 989 TFLOP/s, "
        f"{nbytes} B / 3.35 TB/s) | plain {row['plain_ms']:.4f} ms | library none; device ms "
        f"per launch {row['stages_ms']}")
    return row


#: the first template argument of ``scan_kernel`` (csrc/segment_reduce.cu):
#: which scan it runs, kept in the names ``device_profile`` reports
SCAN_KINDS = ("Segmented", "Prefix", "PrefixReverse")


#: profiler windows tried before a call is said to show no device time
PROFILE_TRIES = 3


def device_profile(fn, reps: int = 10):
    """``({kernel name: device ms per launch}, {kernel name: launches per
    call})`` of ``fn``'s launches, from ``torch.profiler`` over ``reps``
    calls after a warm-up (both empty where the profiler sees no device
    time); a memset is named ``Memset``, a kernel by its name without its
    template arguments, but for a scan's kind (``scan_kernel<Prefix>``).
    Times are per launch seen: over many short back-to-back launches the
    profiler can miss a few, and now and then a whole window, so a window
    with no device time is profiled again, up to ``PROFILE_TRIES`` in all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_time(e):
        t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        return t if getattr(e, "device_type", None) == DeviceType.CUDA else 0

    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if device_time(e) > 0]
        if events:
            break
        log(f"profiler: no device time in window {attempt + 1} of {PROFILE_TRIES}")
    us, count = {}, {}
    for e in events:
        key = e.key.replace("(anonymous namespace)::", "")
        name, _, args = key.split("(")[0].partition("<")
        name = name.split()[-1].split("::")[-1]  # "void ns::ssd_cb" -> "ssd_cb"
        kind = args.split(",")[0].split("::")[-1].strip(" >")
        name += f"<{kind}>" if kind in SCAN_KINDS else ""
        us[name] = us.get(name, 0.0) + device_time(e)
        count[name] = count.get(name, 0) + e.count
    return ({k: round(us[k] / 1e3 / count[k], 6) for k in us},
            {k: round(count[k] / reps, 2) for k in us})


def device_ms_by_kernel(fn, reps: int = 10) -> dict:
    """``{kernel name: device ms per launch}`` of ``fn``'s launches."""
    return device_profile(fn, reps)[0]


def device_ms(fn, reps: int = 10):
    """Device ms per call of ``fn``'s launches, memsets included, from
    ``torch.profiler`` (None where it sees no device time): each kernel's
    time per launch times its launches per call, rounded to a whole count."""
    ms, per_call = device_profile(fn, reps)
    return round(sum(ms[k] * max(1, round(per_call[k])) for k in ms), 6) if ms else None


def host_us(fn, calls: int = 2000) -> float:
    """The host's µs per call of ``fn`` (``time.perf_counter`` over
    ``calls`` calls with no synchronize inside the loop: the time to issue
    one call, while the device keeps up)."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


#: the wide router's entry: Granite-4.0-H's k = 10 of E = 72 at its serve
#: cell's decode tick (128 slots) and a prefill of 1,792 tokens, dropless
#: (capacity T·k, as ``moe_ffn_dropless`` routes)
MOE_WIDE = (72, 10, (128, 1792))


def moe_wide_entry(reps: int):
    """The router kernel's k <= 16 instance at ``MOE_WIDE``, each shape held
    against its plain version (ids, ordinals and keep flags bit for bit;
    weights within ``MOE_W_ATOL``): its launches counted over the entry,
    device time from ``torch.profiler``, the plain version's time and the
    bytes bound."""
    import torch

    from repro_torch.kernels.moe_route.moe_route import moe_route_fwd
    from repro_torch.kernels.moe_route.ref import moe_route_ref

    E, k, Ts = MOE_WIDE
    g = torch.Generator(device="cuda").manual_seed(11)
    out, before = {}, moe_route_fwd.launches
    for T in Ts:
        x = torch.randn((T, E), generator=g, device="cuda")
        C = T * k
        got, ref = moe_route_fwd(x, k, C), moe_route_ref(x, k, C)
        for a, b, nm in zip(got[1:], ref[1:], ("idx", "pos", "keep")):
            exact(a, b, f"moe_route {T}x{E} k={k} C={C} {nm}")
        err = max_err(got[0], ref[0])
        check(err <= MOE_W_ATOL, f"moe_route {T}x{E} k={k}: weights max abs err {err}")
        nbytes = T * E * 4 + T * k * (4 + 4 + 4 + 1)
        by_ms, per_call = device_profile(lambda: moe_route_fwd(x, k, C), 50)
        check(bool(by_ms), f"moe_route {T}x{E} k={k}: the profiler saw no device time")
        r = out[T] = dict(
            shape=[T, E], k=k, capacity=C, max_abs_err=err,
            device_ms=round(sum(by_ms.values()), 6), device_ms_by_kernel=by_ms,
            launches_per_call=per_call,
            plain_ms=time_ms(lambda: moe_route_ref(x, k, C), reps),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes)
        log(f"kernel moe_route (k={k} of E={E}, T={T}): ids, ordinals and keep equal to the "
            f"plain version's, weights max abs err {err} | device {r['device_ms']} ms "
            f"(torch.profiler; {by_ms}, launches per call seen {per_call}) | bound "
            f"{r['bound_ms']:.6f} ms (bytes: {nbytes} B / 3.35 TB/s) | plain "
            f"{r['plain_ms']:.4f} ms")
    launched = moe_route_fwd.launches - before
    check(launched > 0, "moe_route: the wide entry counted no launch")
    log(f"kernel moe_route (k={k} of E={E}): {launched} launches counted over the entry")
    return dict(launches=launched, shapes=out)


def moe_row(launches, reps: int):
    """The router kernel at the Mixtral path's largest prefill and at its
    decode tick (T = 4), each held against its plain version: device time
    from ``torch.profiler`` (the row's ``ms``; CUDA events around
    back-to-back calls time the host's enqueue here, and are kept as
    ``event_ms``), the wrapper's host µs per call, the plain version's time
    and the bound; no PyTorch call computes this function. The k <= 16
    instance's entry (``moe_wide_entry``) is the row's ``wide``."""
    import torch

    from repro_torch.kernels.moe_route.moe_route import moe_route_fwd
    from repro_torch.kernels.moe_route.ref import moe_route_ref

    cnt, _t, geoms = launches["moe_route"]
    g = torch.Generator(device="cuda").manual_seed(7)
    shapes = {}
    for label, pick in (("prefill", max), ("decode", min)):
        (T, E), k, C = pick(geoms, key=lambda gm: gm[0][0])
        x = torch.randn((T, E), generator=g, device="cuda")
        got, ref = moe_route_fwd(x, k, C), moe_route_ref(x, k, C)
        for a, b, nm in zip(got[1:], ref[1:], ("idx", "pos", "keep")):
            exact(a, b, f"moe_route {T}x{E} k={k} C={C} {nm}")
        err = max_err(got[0], ref[0])
        check(err <= MOE_W_ATOL, f"moe_route {T}x{E}: weights max abs err {err}")
        nbytes = T * E * 4 + T * k * (4 + 4 + 4 + 1)
        call = lambda: moe_route_fwd(x, k, C)  # noqa: E731
        by_ms, per_call = device_profile(call, 50)
        shapes[label] = dict(
            shape=[T, E], k=k, capacity=C, max_abs_err=err,
            device_ms=round(sum(by_ms.values()), 6) if by_ms else None,  # one launch of each
            device_ms_by_kernel=by_ms, launches_per_call=per_call, host_us=host_us(call),
            event_ms=time_ms(call, reps * 10),
            plain_ms=time_ms(lambda: moe_route_ref(x, k, C), reps),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes)
        r = shapes[label]
        log(f"kernel moe_route ({label}): logits ({T}, {E}) f32 k={k} capacity {C} max_abs_err "
            f"{err} | device {r['device_ms']} ms (torch.profiler; ms per launch {by_ms}, launches "
            f"per call seen {per_call}) | host {r['host_us']:.2f} us per call of the wrapper | "
            f"CUDA events over back-to-back calls {r['event_ms']:.4f} ms"
            + (f" (earlier design {RECORDED_EARLIER_MS['moe_route']} ms as recorded, not "
               f"measured here)" if label == "prefill" else "")
            + f" | bound {r['bound_ms']:.6f} ms (bytes: {nbytes} B / 3.35 TB/s) | plain "
            f"{r['plain_ms']:.4f} ms | library none")
    pre = shapes["prefill"]
    check(pre["device_ms"] is not None, "moe_route: the profiler saw no device time")
    return dict(
        name="moe_route", route="cuda", source="src/repro_torch/csrc/moe_route.cu",
        replaces="src/repro/kernels/moe_route/moe_route.py:60", launches=cnt,
        max_abs_err=max(pre["max_abs_err"], shapes["decode"]["max_abs_err"]),
        ms=pre["device_ms"], plain_ms=pre["plain_ms"], bound_ms=pre["bound_ms"],
        bound_by="bytes", library_ms=None, device_ms=pre["device_ms"],
        host_us=pre["host_us"], event_ms=pre["event_ms"], shape=pre["shape"], k=pre["k"],
        capacity=pre["capacity"], dtype="torch.float32", decode=shapes["decode"],
        wide=moe_wide_entry(reps))


class _Timed:
    """Host wall (ms, after a device synchronize) of each call of ``fn``,
    with a check that every logit it returns is finite."""

    def __init__(self, fn, what):
        self.fn, self.what, self.ms = fn, what, []

    def __call__(self, *a, **kw):
        import torch

        t0 = time.perf_counter()
        logits, cache = self.fn(*a, **kw)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(logits).all()), f"{self.what}: a logit is not finite")
        return logits, cache


def where_time(what, fn, reps=4):
    """Per call: host wall to enqueue the call (it returns before the
    device finishes), wall to the device's end, and — from
    ``torch.profiler`` over as many calls again — the device's busy time
    (the sum of its kernels' and copies' times; one stream, so they do not
    overlap) and the heaviest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    enq, tot = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enq.append((t1 - t0) * 1e3)
        tot.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    # the device's own events (kernels, copies); an aten op's row repeats
    # the device time of the kernels it launched
    evs = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) == DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in evs) / 1e3 / reps
    wall = sorted(tot)[len(tot) // 2]
    top = sorted(evs, key=dev_us, reverse=True)[:6]
    log(f"where: {what}: enqueue {sorted(enq)[len(enq) // 2]:.3f} ms, to the device's "
        f"end {wall:.3f} ms (median of {reps}); device busy "
        + (f"{busy:.3f} ms per call, idle share {max(0.0, 1 - busy / wall):.3f}"
           if evs else "not measured (the profiler saw no device time)"))
    for e in top:
        log(f"where: {what}:   {dev_us(e) / 1e3 / reps:9.3f} ms/call in {e.count // reps:5d} "
            f"launches of {e.key[:90]}")


def serve_prompts(seed, vocab_size):
    """The shared serve traffic: ``SERVE_REQUESTS`` prompts of 512–2048
    tokens drawn from ``seed``, as (lengths, int32 prompts)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(512, 2049, SERVE_REQUESTS)
    return lens, [rng.integers(0, vocab_size, int(n)).astype(np.int32) for n in lens]


def hold_decode(label, bundle, params, cache, tokens, layers, logits_held=True):
    """One decode step on ``cache`` (its rows and positions as a run left
    them), first with every decode attention call held against
    ``decode_attention_ref`` at its own inputs (``DECODE_TOL``,
    ``DECODE_REL_L2``; ``layers`` calls), then with the plain version in
    place of the kernel. The two steps' logits are held within
    ``SERVE_REL_L2`` of each other where ``logits_held``, else reported: a
    model with top-2 routing sends the roundings in which the two differ to
    other experts. Each step writes its own new row at each slot's
    position first, so the two read the same cache. Returns the logits'
    relative L2."""
    import torch

    import repro_torch.kernels.decode_attention as dpkg
    from repro_torch.kernels.decode_attention.ref import GLOBAL_WINDOW, decode_attention_ref

    kernel = dpkg.decode_attention
    atol, rtol = DECODE_TOL
    worst = {"abs": 0.0, "rel": 0.0, "bad": [], "n": 0}

    def checked(q, k, v, pos, window=GLOBAL_WINDOW, softcap=0.0):
        o = kernel(q, k, v, pos, window=window, softcap=softcap)
        ref = decode_attention_ref(q, k, v, pos, window=window, softcap=softcap)
        rel = rel_l2(o, ref)
        if not (torch.allclose(o.float(), ref.float(), atol=atol, rtol=rtol)
                and rel <= DECODE_REL_L2 and not torch.isnan(o).any()):
            worst["bad"].append(worst["n"])
        worst["abs"] = max(worst["abs"], max_err(o, ref))
        worst["rel"] = max(worst["rel"], rel)
        worst["n"] += 1
        return o

    def plain(q, k, v, pos, window=GLOBAL_WINDOW, softcap=0.0):
        return decode_attention_ref(q, k, v, pos, window=window, softcap=softcap)

    with torch.no_grad():
        with _swapped(dpkg, "decode_attention", checked):
            lk = bundle.decode_step(params, cache, tokens)[0]
        with _swapped(dpkg, "decode_attention", plain):
            lp = bundle.decode_step(params, cache, tokens)[0]
    rel = rel_l2(lk, lp)
    log(f"{label}: one decode step at positions {cache['pos'].tolist()} of a slab of "
        f"{cache['k'].shape[2]}: the decode kernel at each of its {worst['n']} calls' inputs "
        f"against decode_attention_ref: max abs err {worst['abs']}, relative L2 at most "
        f"{worst['rel']:.3e} (tolerances {DECODE_TOL}, {DECODE_REL_L2}); logits through the "
        f"kernel against the plain version's relative L2 {rel:.3e}"
        + (f" (tolerance {SERVE_REL_L2})" if logits_held else " (not held: top-2 routing)")
        + f"; argmax agree on {int((lk.argmax(-1) == lp.argmax(-1)).sum())} of "
        f"{lk.shape[0]}")
    check(worst["n"] == layers and not worst["bad"],
          f"{label}: the decode kernel differs from decode_attention_ref at calls "
          f"{worst['bad']} of {worst['n']} (expected {layers} calls)")
    if logits_held:
        check(rel <= SERVE_REL_L2, f"{label}: decode logits through the kernel and the plain "
              f"version differ: relative L2 {rel}")
    return rel


def serve_phase(args, label, cfg, expect, compare, rel_tol, note="", extra=None):
    """``cfg`` at full width (random weights from a seeded generator) serves
    8 requests of 512–2048 prompt tokens x 32 new tokens through
    ``ServeFrontDoor`` on a cuda worker: continuous batching on 4 slots of a
    4096-position slab, one IJob task of kind ``serve`` per tick.

    ``expect(prefills, ticks)`` gives the launches each kernel of the path
    must make in the run; ``compare(bundle, params, tokens)`` gives the
    last-position logits of a prefill through the path's kernels and through
    their plain versions, held within relative L2 ``rel_tol`` of each other
    on two of the prompts. Where the path decodes through the decode
    kernel (``expect`` names it), one more decode step on the run's final
    cache holds it (``hold_decode``). ``extra(bundle, params)``, when given, runs last
    on the same weights and returns a dict merged into the report. Returns
    ({kernel: (launches, sweep launches, geometries)}, report)."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.core import ICluster, IJob, IProperties, IWorker
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    from repro_torch.streaming import ServeFrontDoor

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"{label}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated "
        f"before the model")
    bundle = build_model(cfg)
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device="cuda").manual_seed(args.seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"{label}: {cfg.name} ({cfg.source}) at full width{note}, {n_params} parameters "
        f"in {cfg.param_dtype}, initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated")

    w = IWorker(ICluster(IProperties({"ignis.device": "cuda"})), "python")
    check(params.device == w.device, f"model on {params.device}, worker on {w.device}")
    engine = ServeEngine(bundle, params, slots=SERVE_SLOTS, cache_len=SERVE_CACHE_LEN)
    prefill = _Timed(bundle.prefill, f"{label} prefill")
    decode = _Timed(bundle.decode_step, f"{label} decode")
    engine.bundle = dataclasses.replace(bundle, prefill=prefill, decode_step=decode)
    job = IJob(label)
    fd = ServeFrontDoor(engine, w, job=job)
    lens, prompts = serve_prompts(args.seed, cfg.vocab_size)

    K.reset_launches()
    t0 = time.perf_counter()
    tickets = [fd.submit(p, max_new_tokens=SERVE_NEW) for p in prompts]
    fd.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fns = K.launch_counters()
    want = expect(len(prefill.ms), len(decode.ms))
    launches = {k: (fns[k].launches, fns[k].tune_launches, sorted(fns[k].geometries))
                for k in want}
    routes = {k: dict(fns[k].launches_by_variant) for k in want if k in PATH_VARIANT}
    peak = torch.cuda.max_memory_allocated()

    done = [t.result(60.0) for t in tickets]
    check(all(r is not None and len(r.tokens) == SERVE_NEW for r in done),
          f"{label}: not every request resolved with {SERVE_NEW} tokens")
    check(len(prefill.ms) == SERVE_REQUESTS, f"{label}: {len(prefill.ms)} prefills")
    for k, n in want.items():
        check(fns[k].launches == n, f"{label}: {k} launches {fns[k].launches}, expected {n}")
        if k in PATH_VARIANT:
            check(fns[k].launches_by_variant == ({PATH_VARIANT[k]: n} if n else {}),
                  f"{label}: {k} launches by route {fns[k].launches_by_variant}, expected "
                  f"all {n} through {PATH_VARIANT[k]}")
    tasks = job.metrics("tasks")
    check(tasks["serve"] > 0 and tasks["failed"] == 0, f"{label}: job tasks {tasks}")
    st = fd.stats()
    gen = sum(len(r.tokens) for r in done)
    log(f"{label}: {len(done)} requests (prompt lengths {lens.tolist()}) x {SERVE_NEW} "
        f"tokens in {wall * 1e3:.1f} ms: {gen / wall:.1f} generated tokens/s; "
        f"{tasks['serve']} serve ticks in the IJob, {len(decode.ms)} decode steps; kernel "
        f"launches { {k: fns[k].launches for k in want} } (expected {want}), by route "
        f"{routes}")
    log(f"{label}: prefill (time to first token) ms per request "
        f"{[round(x, 3) for x in prefill.ms]}; mean {np.mean(prefill.ms):.3f}")
    log(f"{label}: decode ms per tick over {len(decode.ms)} ticks: median "
        f"{np.median(decode.ms):.3f}, mean {np.mean(decode.ms):.3f}, min "
        f"{min(decode.ms):.3f}, max {max(decode.ms):.3f}")
    lat = [t.latency_ms for t in tickets]
    log(f"{label}: request latency p50 {np.percentile(lat, 50):.1f} ms, max "
        f"{max(lat):.1f} ms (from submission; all {SERVE_REQUESTS} queued at once); "
        f"front door {st['ticks']} ticks, {st['telemetry']['completed']} completed; "
        f"peak max_memory_allocated {peak / 2**30:.2f} GiB")

    if want.get("decode_attention"):
        last = torch.as_tensor(engine._last, device="cuda")[:, None]
        hold_decode(label, bundle, params, engine.cache, last,
                    want["decode_attention"] // len(decode.ms), logits_held=not cfg.is_moe)

    # where a tick's and a prefill's time goes: host enqueue against device
    longest = torch.as_tensor(prompts[int(np.argmax(lens))], device="cuda")[None]
    toks = torch.zeros((SERVE_SLOTS, 1), dtype=torch.int32, device="cuda")
    where_time(f"{label} decode tick", lambda: bundle.decode_step(params, engine.cache, toks))
    where_time(f"{label} prefill of {longest.shape[1]} tokens",
               lambda: bundle.prefill(params, tokens=longest))

    # the kernels against their plain versions in prefill, on the same weights
    for i in (int(np.argmin(lens)), int(np.argmax(lens))):
        lk, lp = compare(bundle, params, torch.as_tensor(prompts[i], device="cuda")[None])
        rel = float((lk.float() - lp.float()).norm() / lp.float().norm())
        log(f"{label}: prompt {i} ({len(prompts[i])} tokens): kernels vs plain prefill "
            f"logits relative L2 {rel:.3e} (tolerance {rel_tol}); argmax "
            f"{int(lk.argmax())} vs {int(lp.argmax())}")
        check(rel <= rel_tol, f"{label}: kernel and plain prefill logits differ: rel L2 {rel}")
    report = dict(prefill_ms=prefill.ms, decode_ms=decode.ms, wall_ms=wall * 1e3,
                  tokens_per_s=gen / wall, peak_gib=peak / 2**30)
    if extra:
        report.update(extra(bundle, params))
    del params, engine, fd, bundle
    gc.collect()
    torch.cuda.empty_cache()
    return launches, report


@contextlib.contextmanager
def _swapped(module, name, fn):
    """``module.name`` is ``fn`` inside the block (the models import the
    kernels' wrappers from their packages at each call)."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def serve_qwen(args):
    """Qwen3-14B, nothing cut: every prefill through the flash kernel; the
    plain prefill takes the chunked attention."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("qwen3-14b").with_overrides(attn_impl="flash")
    chunked = build_model(cfg.with_overrides(attn_impl="chunked"))
    return serve_phase(args, "serve", cfg,
                       lambda prefills, ticks: {"flash_attention": cfg.num_layers * prefills,
                                                "decode_attention": cfg.num_layers * ticks},
                       lambda bundle, params, tok: (bundle.prefill(params, tokens=tok)[0],
                                                    chunked.prefill(params, tokens=tok)[0]),
                       SERVE_REL_L2)


def _f32_ssd(x, dt, A_log, Bm, Cm, chunk):
    """``ssd_chunked`` on the same values in f32, y rounded once to x's dtype:
    what the SSD kernel computes."""
    from repro_torch.models.mamba2 import ssd_chunked

    y, st = ssd_chunked(x.float(), dt, A_log, Bm.float(), Cm.float(), chunk)
    return y.to(x.dtype), st


def serve_mamba(args):
    """Mamba2-780M, nothing cut: every prefill's mixers through the SSD
    scan kernel (decode is the O(1) recurrence, as in the JAX package). On
    the served bf16 weights, a prefill through the kernel holds each layer's
    SSD output against ``ssd_chunked`` at that layer's own inputs, and
    reports how far the logits move from ``ssd_chunked``'s in f32 and at the
    JAX function's bf16 cast points; the logits through the kernel and
    through ``ssd_chunked`` are then held in an f32 copy of the weights
    (``SSM_F32_REL_L2``)."""
    import copy

    import numpy as np
    import torch

    import repro_torch.kernels.ssd_scan as pkg
    from repro_torch.configs import get_config
    from repro_torch.models.mamba2 import ssd_chunked

    cfg = get_config("mamba2-780m")
    kernel = pkg.ssd_scan

    def compare(bundle, params, tokens):
        worst = {"y": 0.0, "state": 0.0, "bad": []}

        def checked(x, dt, A_log, Bm, Cm, chunk):
            y, st = kernel(x, dt, A_log, Bm, Cm, chunk)
            yr, sr = ssd_chunked(x.float(), dt, A_log, Bm.float(), Cm.float(), chunk)
            atol, rtol = SSD_TOL[str(x.dtype)]
            if not (torch.allclose(y.float(), yr, atol=atol, rtol=rtol)
                    and torch.allclose(st, sr, atol=2e-4, rtol=1e-3)):
                worst["bad"].append(len(worst["bad"]))
            worst["y"] = max(worst["y"], max_err(y.float(), yr))
            worst["state"] = max(worst["state"], max_err(st, sr))
            return y, st

        with _swapped(pkg, "ssd_scan", checked):
            lk = bundle.prefill(params, tokens=tokens)[0]
        log(f"mamba: {tokens.shape[1]} tokens, the SSD kernel layer by layer against "
            f"ssd_chunked at each layer's inputs: max abs err y {worst['y']}, state "
            f"{worst['state']} (tolerances {SSD_TOL[str(torch.bfloat16)]}, (2e-4, 1e-3))")
        check(not worst["bad"], f"mamba: the SSD kernel differs from ssd_chunked in "
              f"{len(worst['bad'])} layers")
        with _swapped(pkg, "ssd_scan", _f32_ssd):
            lf = bundle.prefill(params, tokens=tokens)[0]
        with _swapped(pkg, "ssd_scan", ssd_chunked):
            lb = bundle.prefill(params, tokens=tokens)[0]
        rel = {k: float((lk.float() - v.float()).norm() / v.float().norm())
               for k, v in (("f32", lf), ("bf16", lb))}
        log(f"mamba: {tokens.shape[1]} tokens, bf16 weights (not held: see SSM_F32_REL_L2): "
            f"kernel vs ssd_chunked in f32 prefill logits relative L2 {rel['f32']:.3e}, "
            f"argmax {int(lk.argmax())} vs {int(lf.argmax())}; vs ssd_chunked at the JAX "
            f"function's bf16 cast points {rel['bf16']:.3e}, argmax {int(lb.argmax())}")
        p32 = copy.deepcopy(params).float()
        lk = bundle.prefill(p32, tokens=tokens)[0]
        with _swapped(pkg, "ssd_scan", ssd_chunked):
            lp = bundle.prefill(p32, tokens=tokens)[0]
        log(f"mamba: {tokens.shape[1]} tokens: the held comparison below runs an f32 copy "
            f"of the weights (logits {lk.dtype})")
        del p32
        return lk, lp

    return serve_phase(args, "mamba", cfg,
                       lambda prefills, ticks: {"ssd_scan": cfg.num_layers * prefills},
                       compare, SSM_F32_REL_L2)


def serve_dense(args, name, flash=True):
    """A dense config at full width, nothing cut: every prefill through the
    flash kernel, or (``flash=False``: gemma3-4b, whose local and global
    layers have different windows, so both packages keep the plain
    attention) through no kernel at all, which the launch check holds at 0;
    the plain prefill takes the chunked attention."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(name).with_overrides(attn_impl="flash")
    chunked = build_model(cfg.with_overrides(attn_impl="chunked"))
    return serve_phase(args, name, cfg,
                       lambda prefills, ticks: {
                           "flash_attention": cfg.num_layers * prefills if flash else 0,
                           "decode_attention": cfg.num_layers * ticks},
                       lambda bundle, params, tok: (bundle.prefill(params, tokens=tok)[0],
                                                    chunked.prefill(params, tokens=tok)[0]),
                       SERVE_REL_L2, note="" if flash else " (plain attention: uneven windows)")


def serve_mixtral(args):
    """Mixtral-8x7B at full width, ``MIXTRAL_LAYERS`` of its 32 layers:
    every prefill through the flash kernel with its 4096 window, every
    prefill and decode step's FFNs through the router kernel; the plain
    prefill takes the router's plain version."""
    return serve_moe(args, "mixtral", "mixtral-8x7b", MIXTRAL_LAYERS,
                     "the weights of all 32 are 93.4 GB in bf16, above the card's 80 GB")


def serve_phi(args):
    """Phi-3.5-MoE (16 experts, top-2) at full width, ``PHI_LAYERS`` of its
    32 layers: every prefill through the flash kernel (no window), every
    prefill and decode step's FFNs through the router kernel."""
    return serve_moe(args, "phi", "phi3.5-moe-42b-a6.6b", PHI_LAYERS,
                     "the weights of all 32 are 83.7 GB in bf16, which with the KV slab "
                     "do not fit the card's 80 GB")


def f32_attention(q, k, v, **kw):
    """``attention_ref`` on f32 copies of q, k, v, rounded once to q's
    dtype: the plain attention with P kept in f32."""
    from repro_torch.kernels.flash_attention.ref import attention_ref

    return attention_ref(q.float(), k.float(), v.float(), **kw).to(q.dtype)


def serve_moe(args, label, name, layers, why):
    """An MoE config at full width and ``layers`` of its layers (``why``
    says why the cut): flash in every prefill (with the config's window),
    the router in every prefill's and decode step's FFNs. A prefill through
    both kernels holds each layer's flash output against ``attention_ref``
    at that layer's own inputs (``FLASH_TOL``, ``FLASH_BF16_REL_L2``), and
    its logits against the same prefill with the router's plain version
    (``MOE_REL_L2``: the router alone). Its logits against ``attention_ref``
    and against the chunked attention, each with the plain router, are
    reported beside the (token, layer) pairs whose two experts differ from
    those ``attention_ref`` gave, and not held: top-2 routing is
    discontinuous, so the roundings in which two attentions differ send
    some pairs to other experts, and 24 random bf16 layers carry that to the
    logits (flash against ``attention_ref``: 2.8e-3 relative L2 a layer at
    Mixtral's inputs, 9.0e-2 in its logits; NVIDIA H100 80GB HBM3, 700 W).
    As a control, ``attention_ref`` on f32 copies of q, k, v (P kept in
    f32, as flash's fma route keeps it; the output rounded to bf16 once)
    runs the same prefill: a plain attention that differs from
    ``attention_ref`` by its roundings alone."""
    import torch

    import repro_torch.kernels.flash_attention as fpkg
    import repro_torch.kernels.moe_route as pkg
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.moe_route.ref import moe_route_ref
    from repro_torch.models import build_model

    full = get_config(name)
    cfg = full.with_overrides(num_layers=layers, attn_impl="flash")
    chunked = build_model(cfg.with_overrides(attn_impl="chunked"))
    kernel = fpkg.flash_attention
    atol, rtol = FLASH_TOL[str(torch.bfloat16)]

    def plain(logits, k, capacity, *a):
        return moe_route_ref(logits, k, capacity)

    def compare(bundle, params, tokens):
        worst = {"abs": 0.0, "rel": 0.0, "f32": 0.0, "bad": [], "n": 0}

        def checked(q, k, v, causal=True, window=None, softcap=0.0, q_offset=0, **kw):
            o = kernel(q, k, v, causal=causal, window=window, softcap=softcap,
                       q_offset=q_offset, **kw)
            ref = attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                                q_offset=q_offset)
            worst["f32"] = max(worst["f32"], rel_l2(f32_attention(
                q, k, v, causal=causal, window=window, softcap=softcap, q_offset=q_offset), ref))
            rel = rel_l2(o, ref)
            if not (torch.allclose(o.float(), ref.float(), atol=atol, rtol=rtol)
                    and rel <= FLASH_BF16_REL_L2 and not torch.isnan(o).any()):
                worst["bad"].append(worst["n"])
            worst["abs"] = max(worst["abs"], max_err(o, ref))
            worst["rel"] = max(worst["rel"], rel)
            worst["n"] += 1
            return o

        with _swapped(fpkg, "flash_attention", checked):
            lk = bundle.prefill(params, tokens=tokens)[0]
        log(f"{label}: {tokens.shape[1]} tokens, the flash kernel layer by layer against "
            f"attention_ref at each layer's inputs (q {cfg.num_heads} heads, k/v "
            f"{cfg.num_kv_heads}, hd {cfg.head_dim}): {worst['n']} layers, max abs err "
            f"{worst['abs']}, relative L2 at most {worst['rel']:.3e} (tolerances "
            f"{(atol, rtol)}, {FLASH_BF16_REL_L2}); the f32 control against attention_ref "
            f"at the same inputs: relative L2 at most {worst['f32']:.3e}")
        check(worst["n"] == cfg.num_layers and not worst["bad"],
              f"{label}: the flash kernel differs from attention_ref in layers "
              f"{worst['bad']} of {worst['n']}")
        experts = {}

        def recording(tag):
            def route(logits, k, capacity, *a):
                out = moe_route_ref(logits, k, capacity)
                experts.setdefault(tag, []).append(out[1].sort(-1).values)
                return out
            return route

        def ref(q, k, v, causal=True, window=None, softcap=0.0, q_offset=0, **kw):
            return attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                                 q_offset=q_offset)

        def f32(q, k, v, causal=True, window=None, softcap=0.0, q_offset=0, **kw):
            return f32_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                                 q_offset=q_offset)

        with _swapped(pkg, "moe_route", recording("flash")):
            lr = bundle.prefill(params, tokens=tokens)[0]
        logits = {}
        for tag, attn in (("attention_ref", ref), ("f32 control", f32)):
            with _swapped(pkg, "moe_route", recording(tag)), \
                    _swapped(fpkg, "flash_attention", attn):
                logits[tag] = bundle.prefill(params, tokens=tokens)[0]
        with _swapped(pkg, "moe_route", recording("chunked")):
            logits["chunked"] = chunked.prefill(params, tokens=tokens)[0]
        lf = logits.pop("attention_ref")
        moved = {tag: sum(int((a != b).any(-1).sum())
                          for a, b in zip(experts["attention_ref"], experts[tag], strict=True))
                 for tag in ("flash", "f32 control", "chunked")}
        rels = {"flash": f"{rel_l2(lk, lf):.3e}",
                **{tag: f"{rel_l2(lo, lf):.3e}" for tag, lo in logits.items()}}
        log(f"{label}: {tokens.shape[1]} tokens, not held (see serve_moe): prefill logits "
            f"relative L2 against attention_ref's {rels} (each with the plain router); "
            f"(token, layer) pairs routed to other experts than attention_ref's {moved} of "
            f"{tokens.shape[1] * cfg.num_layers}; argmax attention_ref {int(lf.argmax())}, "
            f"flash {int(lk.argmax())}, "
            f"{ {tag: int(lo.argmax()) for tag, lo in logits.items()} }")
        return lk, lr

    launches, report = serve_phase(
        args, label, cfg,
        lambda prefills, ticks: {"flash_attention": cfg.num_layers * prefills,
                                 "decode_attention": cfg.num_layers * ticks,
                                 "moe_route": cfg.num_layers * (prefills + ticks)},
        compare, MOE_REL_L2,
        note=f", {cfg.num_layers} of its {full.num_layers} layers ({why}); "
             f"{full.num_experts} experts, top-{full.experts_per_token}")
    windows = {g[4] for g in launches["flash_attention"][2]}
    check(windows == {full.sliding_window or None}, f"{label}: flash windows {windows}")
    return launches, report


# ---------------------------------------------------------------------------
# the other families: Jamba (hybrid), InternVL2 (VLM), Whisper (audio)
# ---------------------------------------------------------------------------

#: Jamba-1.5-Large at full width: one block of its nine (``JAMBA_LAYERS`` of
#: 72 layers) with ``JAMBA_EXPERTS`` of its 16 experts in each MoE slot,
#: top-2 kept (the JAX ``analytic_param_count``): one block with all 16 is
#: 45.14e9 parameters, 84.1 GiB in bf16, above the card's 80 GB; with 12,
#: 66.1 GiB, no room left to draw the weights and prefill; with 8, 25.82e9
#: (48.1 GiB)
JAMBA_LAYERS = 8
JAMBA_EXPERTS = 8
#: the batch of InternVL2's patch prefix outside the engine: batch, patches
#: (of width ``VIT_DIM``), text tokens; then ``SERVE_NEW`` decode steps
INTERNVL_PATCH_BATCH = (4, 256, 1024)
#: Whisper's serve cell: batches of clips, clips a batch (``enc_seq`` frames
#: each, the decoder prompt ``WHISPER_PREFILL_DEC`` tokens), then
#: ``SERVE_NEW`` decode steps
WHISPER_BATCHES, WHISPER_CLIPS = 2, 4
#: the decoder rows of each kind of flash call in Whisper's prefill, by its
#: index among a prefill's calls: the first encoder layer, then the first
#: decoder layer's self- and cross-attention (``enc_layers`` + 0, + 1)
WHISPER_FLASH_KINDS = ("encoder", "decoder self", "decoder cross")


def _flash_holder(label, worst):
    """The package's flash wrapper, each call held against ``attention_ref``
    at its own inputs (``FLASH_TOL`` elementwise, ``FLASH_BF16_REL_L2``);
    ``worst`` gathers the largest errors and the failing calls."""
    import torch

    import repro_torch.kernels.flash_attention as fpkg
    from repro_torch.kernels.flash_attention.ref import attention_ref

    kernel = fpkg.flash_attention

    def checked(q, k, v, causal=True, window=None, softcap=0.0, q_offset=0, **kw):
        o = kernel(q, k, v, causal=causal, window=window, softcap=softcap, q_offset=q_offset,
                   **kw)
        ref = attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                            q_offset=q_offset)
        atol, rtol = FLASH_TOL[str(q.dtype)]
        rel = rel_l2(o, ref)
        if not (torch.allclose(o.float(), ref.float(), atol=atol, rtol=rtol)
                and rel <= FLASH_BF16_REL_L2 and not torch.isnan(o).any()):
            worst["bad"].append(worst["n"])
        worst["abs"] = max(worst["abs"], max_err(o, ref))
        worst["rel"] = max(worst["rel"], rel)
        worst["n"] += 1
        worst.setdefault("shapes", set()).add((tuple(q.shape), tuple(k.shape), bool(causal),
                                               int(q_offset)))
        return o
    return checked


def _jamba_splice_check(real, seen):
    """The engine's ``_splice`` (``real``), then a check that the slab's rows
    of the admitted slot equal the request's own prefill cache bit for bit
    (k/v for its Lp rows and zeros past them, the mixers' conv tails and
    states, pos) and that every other slot is unchanged; ``seen`` gets one
    verdict an admission."""
    import torch

    axes = {"k": 1, "v": 1, "conv": 2, "state": 2, "pos": 0}

    def spliced(cache, cache1, slot, cache_len):
        before = {k: cache[k].clone() for k in axes}
        out = real(cache, cache1, slot, cache_len)
        ok = set(cache) == set(axes)
        for k, a in axes.items():
            got, want = cache[k].select(a, slot), cache1[k].select(a, 0).to(cache[k].dtype)
            if k in ("k", "v"):  # the length axis is now axis a
                lp = want.shape[a]
                ok = ok and torch.equal(got.narrow(a, 0, lp), want) \
                    and not got.narrow(a, lp, cache_len - lp).any()
            else:
                ok = ok and torch.equal(got, want)
            ok = ok and all(torch.equal(cache[k].select(a, s), before[k].select(a, s))
                            for s in range(cache[k].shape[a]) if s != slot)
        seen.append(ok)
        return out
    return spliced


def serve_jamba(args):
    """Jamba-1.5-Large at full width, ``JAMBA_LAYERS`` of its 72 layers with
    ``JAMBA_EXPERTS`` experts a MoE slot: the attention slot of every
    prefill through flash (no RoPE, G = 8), its 7 mixers through the SSD
    scan (256 heads), its 4 MoE slots (1, 3, 5, 7) through the router in
    every prefill and decode step. Each admission's splice is checked
    (``_jamba_splice_check``) in a second, untimed engine run of the same
    traffic. A prefill holds flash at the attention slot
    against ``attention_ref``, the SSD at each mixer against
    ``ssd_chunked`` in f32 (``SSD_TOL``) and the router at each MoE slot
    against ``moe_route_ref`` (ids, ordinals and keep flags bit for bit,
    weights within ``MOE_W_ATOL``), each at its own inputs; its logits are
    held against the same prefill with the router's plain version
    (``MOE_REL_L2``: the router alone). The logits against the all-plain
    prefill (``attention_ref``, ``ssd_chunked``, ``moe_route_ref``) are
    reported, not held: random bf16 stacks with top-2 routing are chaotic.
    Returns ({kernel: launches in the engine's run}, report)."""
    import torch

    import repro_torch.kernels.flash_attention as fpkg
    import repro_torch.kernels.moe_route as mpkg
    import repro_torch.kernels.ssd_scan as spkg
    import repro_torch.serving.engine as engine_mod
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.moe_route.ref import moe_route_ref
    from repro_torch.models.mamba2 import ssd_chunked
    from repro_torch.serving import Request, ServeEngine

    full = get_config("jamba-1.5-large-398b")
    cfg = full.with_overrides(num_layers=JAMBA_LAYERS, num_experts=JAMBA_EXPERTS,
                              attn_impl="flash")
    n_mixers, n_moe = 7, 4
    ssd_kernel, route_kernel = spkg.ssd_scan, mpkg.moe_route

    def plain_route(logits, k, capacity, *a):
        return moe_route_ref(logits, k, capacity)

    def plain_flash(q, k, v, causal=True, window=None, softcap=0.0, q_offset=0, **kw):
        return attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                             q_offset=q_offset)

    def compare(bundle, params, tokens):
        worst = {"abs": 0.0, "rel": 0.0, "bad": [], "n": 0}
        ssd, routes = [], []

        def ssd_checked(x, dt, A_log, Bm, Cm, chunk):
            y, st = ssd_kernel(x, dt, A_log, Bm, Cm, chunk)
            yr, sr = ssd_chunked(x.float(), dt, A_log, Bm.float(), Cm.float(), chunk)
            atol, rtol = SSD_TOL[str(x.dtype)]
            ssd.append((max_err(y.float(), yr), max_err(st, sr),
                        torch.allclose(y.float(), yr, atol=atol, rtol=rtol)
                        and torch.allclose(st, sr, atol=2e-4, rtol=1e-3), tuple(x.shape)))
            return y, st

        def route_checked(logits, k, capacity, *a):
            out = route_kernel(logits, k, capacity, *a)
            ref = moe_route_ref(logits, k, capacity)
            same = all(a_.dtype == b_.dtype and torch.equal(a_, b_)
                       for a_, b_ in zip(out[1:], ref[1:]))
            routes.append((max_err(out[0], ref[0]), same, tuple(logits.shape)))
            return out

        with _swapped(fpkg, "flash_attention", _flash_holder("jamba", worst)), \
                _swapped(spkg, "ssd_scan", ssd_checked), \
                _swapped(mpkg, "moe_route", route_checked):
            lk = bundle.prefill(params, tokens=tokens)[0]
        log(f"jamba: {tokens.shape[1]} tokens, each kernel at its own inputs: flash at the "
            f"attention slot {sorted(worst['shapes'])}: max abs err {worst['abs']}, "
            f"relative L2 {worst['rel']:.3e} (tolerances {FLASH_TOL[str(torch.bfloat16)]}, "
            f"{FLASH_BF16_REL_L2}); SSD at {len(ssd)} mixers x {ssd[0][3]}: max abs err y "
            f"{max(e[0] for e in ssd)}, state {max(e[1] for e in ssd)} (tolerances "
            f"{SSD_TOL[str(torch.bfloat16)]}, (2e-4, 1e-3)); router at {len(routes)} MoE "
            f"slots, logits {routes[0][2]}: ids, ordinals and keep "
            f"{'bit for bit' if all(r[1] for r in routes) else 'DIFFER'}, weights max abs "
            f"err {max(r[0] for r in routes)} (tolerance {MOE_W_ATOL})")
        check(worst["n"] == 1 and not worst["bad"],
              f"jamba: flash differs from attention_ref ({worst['n']} calls, bad "
              f"{worst['bad']})")
        check(len(ssd) == n_mixers and all(e[2] for e in ssd),
              f"jamba: the SSD kernel differs from ssd_chunked at mixers "
              f"{[i for i, e in enumerate(ssd) if not e[2]]} of {len(ssd)}")
        check(len(routes) == n_moe and all(r[1] and r[0] <= MOE_W_ATOL for r in routes),
              f"jamba: the router differs from moe_route_ref at slots "
              f"{[i for i, r in enumerate(routes) if not (r[1] and r[0] <= MOE_W_ATOL)]}")
        with _swapped(mpkg, "moe_route", plain_route):
            lr = bundle.prefill(params, tokens=tokens)[0]
        with _swapped(mpkg, "moe_route", plain_route), \
                _swapped(fpkg, "flash_attention", plain_flash), \
                _swapped(spkg, "ssd_scan", ssd_chunked):
            lp = bundle.prefill(params, tokens=tokens)[0]
        log(f"jamba: {tokens.shape[1]} tokens, not held (random bf16 stacks with top-2 "
            f"routing are chaotic): prefill logits through the kernels against the all-plain "
            f"prefill (attention_ref, ssd_chunked, moe_route_ref) relative L2 "
            f"{rel_l2(lk, lp):.3e}, argmax {int(lk.argmax())} vs {int(lp.argmax())}")
        return lk, lr

    def splice_run(bundle, params):
        # the same traffic through a second engine, after the timed run, so
        # that the check's copies and syncs stay out of the timed window
        spliced = []
        engine = ServeEngine(bundle, params, slots=SERVE_SLOTS, cache_len=SERVE_CACHE_LEN)
        for i, p in enumerate(serve_prompts(args.seed, cfg.vocab_size)[1]):
            engine.submit(Request(i, p, max_new_tokens=SERVE_NEW))
        with _swapped(engine_mod, "_splice", _jamba_splice_check(engine_mod._splice, spliced)):
            done = engine.run_to_completion()
        log(f"jamba: splice check in an untimed second engine run, at {len(spliced)} "
            f"admissions: "
            f"{'every slot equal to its request cache, the others unchanged' if all(spliced) else spliced}")
        check(len(done) == SERVE_REQUESTS and len(spliced) == SERVE_REQUESTS and all(spliced),
              f"jamba: the engine spliced a request cache wrongly: {spliced}")
        return {"splice_checked": len(spliced)}

    launches, report = serve_phase(
        args, "jamba", cfg,
        lambda prefills, ticks: {"flash_attention": prefills,
                                 "decode_attention": ticks,
                                 "ssd_scan": n_mixers * prefills,
                                 "moe_route": n_moe * (prefills + ticks)},
        compare, MOE_REL_L2,
        note=f", {cfg.num_layers} of its {full.num_layers} layers (one block) with "
             f"{cfg.num_experts} of its {full.num_experts} experts a MoE slot, top-"
             f"{cfg.experts_per_token} (JAMBA_LAYERS, JAMBA_EXPERTS: one whole block "
             f"is 84.1 GiB in bf16)", extra=splice_run)
    return {k: v[0] for k, v in launches.items()}, report


def serve_internvl(args):
    """InternVL2-1B, whole: the shared traffic through the engine, text-only
    (the engine feeds token prompts, as the JAX engine does), every prefill
    through flash (G = 7, hd 64); then one batch of ``INTERNVL_PATCH_BATCH``
    through ``bundle.prefill(tokens=, patches=)`` (256 patches of width
    ``VIT_DIM`` prepended, a cache of 1312) and ``SERVE_NEW`` decode steps.
    Prefill logits against the chunked attention's at ``SERVE_REL_L2``, with
    and without the patch prefix. Returns ({kernel: launches, the patch
    batch's included}, report)."""
    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.model_zoo import VIT_DIM

    cfg = get_config("internvl2-1b").with_overrides(attn_impl="flash")
    chunked = build_model(cfg.with_overrides(attn_impl="chunked"))
    B, P, S = INTERNVL_PATCH_BATCH
    patch_launches = {}

    def patch_batch(bundle, params):
        g = torch.Generator(device="cuda").manual_seed(args.seed + 1)
        patches = torch.randn((B, P, VIT_DIM), generator=g, device="cuda").to(torch.bfloat16)
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device="cuda",
                               dtype=torch.int32)
        cache_len = P + S + SERVE_NEW
        K.reset_launches()
        (logits, cache), pre_ms = timed(lambda: bundle.prefill(
            params, tokens=tokens, patches=patches, cache_len=cache_len))
        steps = []
        for _ in range(SERVE_NEW):
            nxt = logits.argmax(-1).to(torch.int32)[:, None]
            (logits, cache), ms = timed(lambda: bundle.decode_step(params, cache, nxt))
            steps.append(ms)
        fns = K.launch_counters()
        patch_launches.update({k: fn.launches for k, fn in fns.items()})
        check(bool(torch.isfinite(logits).all()), "internvl: a decode logit is not finite")
        decodes = cfg.num_layers * SERVE_NEW
        check(patch_launches == {**{k: 0 for k in fns}, "flash_attention": cfg.num_layers,
                                 "decode_attention": decodes}
              and fns["flash_attention"].launches_by_variant == {"wgmma": cfg.num_layers}
              and fns["decode_attention"].launches_by_variant == {"split": decodes},
              f"internvl: the patch batch launched {patch_launches}, expected flash "
              f"{cfg.num_layers} on wgmma and decode {decodes} split")
        check(int(cache["pos"][0]) == cache_len, f"internvl: pos {cache['pos'].tolist()}")
        lk = bundle.prefill(params, tokens=tokens, patches=patches, cache_len=cache_len)[0]
        lc = chunked.prefill(params, tokens=tokens, patches=patches, cache_len=cache_len)[0]
        rel = rel_l2(lk, lc)
        log(f"internvl: patch batch {B} x ({P} patches of {VIT_DIM} + {S} tokens), cache "
            f"{cache_len}: prefill {pre_ms:.3f} ms, decode ms per step median "
            f"{np.median(steps):.3f} over {SERVE_NEW} ({B * SERVE_NEW / (sum(steps) / 1e3):.1f} "
            f"tokens/s in decode), latency {pre_ms + sum(steps):.1f} ms; flash launches "
            f"{cfg.num_layers}; prefill logits against the chunked attention's relative L2 "
            f"{rel:.3e} (tolerance {SERVE_REL_L2})")
        check(rel <= SERVE_REL_L2, f"internvl: flash and chunked patch-prefill logits differ: "
              f"rel L2 {rel}")
        nxt = torch.zeros((B, 1), dtype=torch.int32, device="cuda")
        where_time("internvl patch-batch decode step",
                   lambda: bundle.decode_step(params, cache, nxt))
        where_time(f"internvl prefill of {B} x ({P} patches + {S} tokens)",
                   lambda: bundle.prefill(params, tokens=tokens, patches=patches,
                                          cache_len=cache_len))
        return dict(patch_prefill_ms=pre_ms, patch_decode_ms=steps, patch_rel_l2=rel)

    launches, report = serve_phase(
        args, "internvl", cfg,
        lambda prefills, ticks: {"flash_attention": cfg.num_layers * prefills,
                                 "decode_attention": cfg.num_layers * ticks},
        lambda bundle, params, tok: (bundle.prefill(params, tokens=tok)[0],
                                     chunked.prefill(params, tokens=tok)[0]),
        SERVE_REL_L2, note=" (text-only through the engine, as the JAX engine serves it)",
        extra=patch_batch)
    total = {k: v[0] + patch_launches.get(k, 0) for k, v in launches.items()}
    log(f"internvl: flash launches {total['flash_attention']} = {cfg.num_layers} x "
        f"({SERVE_REQUESTS} engine prefills + the patch batch)")
    return total, report


def serve_whisper(args):
    """Whisper-tiny, whole (4 encoder and 4 decoder layers), through the
    bundle (the engine feeds token prompts, as the JAX one): ``WHISPER_BATCHES``
    batches of ``WHISPER_CLIPS`` clips, each ``frames`` (clips, ``enc_seq``,
    D) bf16 and a decoder prompt of ``WHISPER_PREFILL_DEC`` tokens through
    ``bundle.prefill(frames=, tokens=)``, then ``SERVE_NEW`` decode steps (a
    k/v slab with room for them). Flash: 4 encoder (not causal), 4 decoder
    self (causal), 4 cross (Sq 256 against Skv 1500, not causal, q_offset 0)
    per prefill, none in decode (the cached cross K/V meet the plain
    ``attend``, as in the JAX package); the decoder's self-attention decodes
    through the decode kernel, 4 calls a step (``hold_decode`` holds one
    step). Each kind of flash call is held at its first layer's own inputs
    against ``attention_ref``; the prefill logits against the chunked
    attention's at ``SERVE_REL_L2``."""
    import gc

    import numpy as np
    import torch
    import torch.nn.functional as Fn

    import repro_torch.kernels.flash_attention as fpkg
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.model_zoo import WHISPER_PREFILL_DEC

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("whisper-tiny").with_overrides(attn_impl="flash")
    bundle = build_model(cfg)
    chunked = build_model(cfg.with_overrides(attn_impl="chunked"))
    params = bundle.init(torch.Generator(device="cuda").manual_seed(args.seed))
    n_params = sum(p.numel() for p in params.parameters())
    log(f"whisper: {cfg.name} ({cfg.source}) whole, {n_params} parameters in "
        f"{cfg.param_dtype} (position tables of {params.pos_dec.shape[0]}, as the bundle "
        f"sizes them); {WHISPER_BATCHES} batches of {WHISPER_CLIPS} clips x {cfg.enc_seq} "
        f"frames, prompts of {WHISPER_PREFILL_DEC} tokens, {SERVE_NEW} new tokens each")
    g = torch.Generator(device="cuda").manual_seed(args.seed + 2)
    batches = [(torch.randn((WHISPER_CLIPS, cfg.enc_seq, cfg.d_model), generator=g,
                            device="cuda").to(torch.bfloat16),
                torch.randint(0, cfg.vocab_size, (WHISPER_CLIPS, WHISPER_PREFILL_DEC),
                              generator=g, device="cuda", dtype=torch.int32))
               for _ in range(WHISPER_BATCHES)]
    pad = (0, 0, 0, 0, 0, SERVE_NEW)  # room on the k/v slab's length axis

    K.reset_launches()
    prefill_ms, decode_ms, latency, caches = [], [], [], []
    t_all = time.perf_counter()
    for frames, tokens in batches:
        t0 = time.perf_counter()
        (logits, cache), ms = timed(lambda: bundle.prefill(params, frames=frames,
                                                           tokens=tokens))
        prefill_ms.append(ms)
        check(bool(torch.isfinite(logits).all()), "whisper: a prefill logit is not finite")
        cache = {**cache, "k": Fn.pad(cache["k"], pad), "v": Fn.pad(cache["v"], pad)}
        for _ in range(SERVE_NEW - 1):
            nxt = logits.argmax(-1).to(torch.int32)[:, None]
            (logits, cache), ms = timed(lambda: bundle.decode_step(params, cache, nxt))
            decode_ms.append(ms)
        check(bool(torch.isfinite(logits).all()), "whisper: a decode logit is not finite")
        latency.append((time.perf_counter() - t0) * 1e3)
        caches.append(cache)
    wall = time.perf_counter() - t_all
    fns = K.launch_counters()
    launches = {k: fn.launches for k, fn in fns.items()}
    per_prefill = cfg.enc_layers + 2 * cfg.num_layers
    want = {**{k: 0 for k in fns}, "flash_attention": per_prefill * WHISPER_BATCHES,
            "decode_attention": cfg.num_layers * (SERVE_NEW - 1) * WHISPER_BATCHES}
    check(launches == want and fns["flash_attention"].launches_by_variant
          == {"wgmma": want["flash_attention"]}
          and fns["decode_attention"].launches_by_variant == {"split": want["decode_attention"]},
          f"whisper: launches {launches} by route "
          f"{fns['flash_attention'].launches_by_variant} and "
          f"{fns['decode_attention'].launches_by_variant}, expected {want}, flash on wgmma "
          f"and decode split")
    peak = torch.cuda.max_memory_allocated()
    gen = WHISPER_BATCHES * WHISPER_CLIPS * SERVE_NEW
    log(f"whisper: {WHISPER_BATCHES * WHISPER_CLIPS} requests x {SERVE_NEW} tokens in "
        f"{wall * 1e3:.1f} ms: {gen / wall:.1f} generated tokens/s; flash launches "
        f"{launches['flash_attention']} ({per_prefill} a prefill, none in decode), decode "
        f"launches {launches['decode_attention']}; prefill ms "
        f"{[round(x, 3) for x in prefill_ms]}; decode ms per step median "
        f"{np.median(decode_ms):.3f}, mean {np.mean(decode_ms):.3f} over {len(decode_ms)}; "
        f"latency per batch {[round(x, 1) for x in latency]} ms; peak max_memory_allocated "
        f"{peak / 2**30:.2f} GiB")

    frames, tokens = batches[0]
    seen = []
    with torch.no_grad(), _swapped(fpkg, "flash_attention",
                                   _recording(seen, fpkg.flash_attention, per_prefill)):
        bundle.prefill(params, frames=frames, tokens=tokens)
    for kind, i in zip(WHISPER_FLASH_KINDS, (0, cfg.enc_layers, cfg.enc_layers + 1)):
        worst = {"abs": 0.0, "rel": 0.0, "bad": [], "n": 0}
        q, k, v, causal, window, softcap, q_offset = seen[i][:7]
        _flash_holder("whisper", worst)(q, k, v, causal, window, softcap, q_offset)
        log(f"whisper: flash {kind} at layer 0's inputs q {tuple(q.shape)} k "
            f"{tuple(k.shape)} causal {causal} q_offset {q_offset}: max abs err "
            f"{worst['abs']}, relative L2 {worst['rel']:.3e}")
        check(not worst["bad"], f"whisper: flash {kind} differs from attention_ref")
    check(seen[cfg.enc_layers + 1][1].shape[2] == cfg.enc_seq
          and not seen[cfg.enc_layers + 1][3], "whisper: the cross call is not (Skv 1500, "
          "not causal)")
    for frames, tokens in batches:
        lk = bundle.prefill(params, frames=frames, tokens=tokens)[0]
        lc = chunked.prefill(params, frames=frames, tokens=tokens)[0]
        rel = rel_l2(lk, lc)
        log(f"whisper: prefill logits against the chunked attention's relative L2 {rel:.3e} "
            f"(tolerance {SERVE_REL_L2}); argmax agree on "
            f"{int((lk.argmax(-1) == lc.argmax(-1)).sum())} of {WHISPER_CLIPS}")
        check(rel <= SERVE_REL_L2, f"whisper: flash and chunked prefill logits differ: {rel}")
    nxt = torch.zeros((WHISPER_CLIPS, 1), dtype=torch.int32, device="cuda")
    hold_decode("whisper", bundle, params, caches[0], nxt, cfg.num_layers)
    where_time("whisper decode step", lambda: bundle.decode_step(params, caches[0], nxt))
    where_time(f"whisper prefill of {WHISPER_CLIPS} x ({cfg.enc_seq} frames + "
               f"{WHISPER_PREFILL_DEC} tokens)",
               lambda: bundle.prefill(params, frames=frames, tokens=tokens))
    report = dict(prefill_ms=prefill_ms, decode_ms=decode_ms, latency_ms=latency,
                  tokens_per_s=gen / wall, peak_gib=peak / 2**30)
    del params, bundle, chunked, caches, batches, seen
    gc.collect()
    torch.cuda.empty_cache()
    return launches, report


#: the family serve phases, in order, and the row key of their launches
FAMILY_PHASES = (("jamba", serve_jamba), ("internvl", serve_internvl),
                 ("whisper", serve_whisper))


# ---------------------------------------------------------------------------
# the train phase
# ---------------------------------------------------------------------------

#: the train runs: the hybrid app (``examples/torch_hybrid_train.py``'s two
#: phases at ``ignis-100m``: batch, sequence, steps, then the resumed run's
#: steps), and (batch, sequence, steps) of the three model runs
TRAIN_HYBRID = dict(batch=8, seq_len=256, steps=60, more=80)
TRAIN_RUNS = {"olmo": (4, 2048, 6), "mamba": (4, 2048, 6), "mixtral": (1, 2048, 4)}
#: Mixtral-8x7B's layers trained at full width: all 32 are 46.7e9 parameters,
#: some 560 GB with bf16 weights and gradients and f32 Adam moments (12 B a
#: parameter); 2 are 3.2e9, some 45 GB with the optimizer's temporaries
MIXTRAL_TRAIN_LAYERS = 2
#: OLMo-1B's first-step loss through flash against the chunked attention's
#: from the same weights and batch: 16 random bf16 layers carry each layer's
#: bf16 rounding difference (the serve path's 1.3e-2 in logits); the loss, a
#: mean over 8192 tokens, moves far less
TRAIN_LOSS_REL = 2e-2


@contextlib.contextmanager
def _deterministic():
    """Deterministic kernels where torch has them (``index_add_``,
    ``scatter_add_``: the backwards of ``repeat_interleave`` and
    ``gather``), so one computation run twice gives the same bits."""
    import torch

    prev, warn = (torch.are_deterministic_algorithms_enabled(),
                  torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn)


def _recording(store, fn, calls=1):
    """``fn`` that keeps contiguous detached copies of the positional
    arguments of its first ``calls`` calls in ``store``, one list a call
    (the path's own inputs to a kernel: the first layers')."""
    import torch

    def wrapped(*a, **kw):
        if len(store) < calls:
            store.append([x.detach().clone(memory_format=torch.contiguous_format)
                          if isinstance(x, torch.Tensor) else x for x in a])
        return fn(*a, **kw)
    return wrapped


def _same_grads(label, fn_grads, plain_a, plain_b, names):
    """Checks the Function's gradients equal the plain version's autograd
    bit for bit; ``plain_b`` (the plain version again) shows whether the
    plain computation itself repeats."""
    import torch

    for nm, a, b, c in zip(names, fn_grads, plain_a, plain_b, strict=True):
        repeat = torch.equal(b, c)
        err = max_err(a, b) if a.shape == b.shape else float("inf")
        log(f"train: {label}: d{nm} of the Function against the plain version's autograd: "
            f"max abs err {err} ({'bit for bit' if torch.equal(a, b) else 'NOT bit for bit'}); "
            f"the plain backward run twice {'repeats' if repeat else 'does NOT repeat'} "
            f"(max abs {max_err(b, c)})")
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"{label}: the Function's d{nm} differs from the plain version's autograd")


#: the flash backward kernel's dq, dk and dv against the plain vjp in f32
#: from the same bf16 inputs, relative L2 a tensor: the kernel rounds P and
#: dS to bf16 before the products that take them and its gradients at the
#: end, and sums dQ over key blocks with atomics in no fixed order (the
#: plain vjp in bf16 reads some 4e-3 against f32; the CUDA tests of
#: tests/test_torch_flash_backward.py hold the same limit)
FLASH_BWD_REL_L2 = 1.5e-2


def flash_bwd_bound_ms(q_shape, k_shape, kw) -> float:
    """The least time of the flash backward on this card: its five products
    over the live pairs (10·hd a pair and head) at the bf16 peak, or q, o,
    dO, dq, k, v, dk, dv in bf16 and two f32 rows statistics once at the
    HBM rate, whichever is longer."""
    from repro_torch.kernels.flash_attention.flash_attention import live_pairs

    B, H, Sq, hd = q_shape
    K, Skv = k_shape[1], k_shape[2]
    flop = 10 * hd * B * H * live_pairs(Sq, Skv, kw["causal"], kw["window"], kw["q_offset"])
    nbytes = 2 * hd * (4 * B * H * Sq + 4 * B * K * Skv) + 8 * B * H * Sq
    return 1e3 * max(flop / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


def hold_flash_backward(qkv, kw):
    """Flash at the path's own (q, k, v): the Function's forward (the kernel)
    against ``attention_ref``, and its backward against ``attention_ref``'s
    autograd with the same upstream gradient: on the ``wgmma`` route (the
    backward kernel) each of dq, dk, dv against the plain vjp in f32 within
    ``FLASH_BWD_REL_L2`` (no longer the same computation), elsewhere bit for
    bit (the plain vjp itself). Returns the forward kernel's, the plain
    backward's and the backward kernel's device ms (None off the kernel
    route)."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)
    from repro_torch.kernels.flash_attention.ops import kernel_backward
    from repro_torch.kernels.flash_attention.ref import attention_ref

    leaves = [t.detach().clone().requires_grad_() for t in qkv]
    o = flash_attention(*leaves, **kw)
    g = torch.randn(o.shape, generator=torch.Generator(device="cuda").manual_seed(11),
                    device="cuda").to(o.dtype)

    def plain(xs=qkv, grad=g):
        xs = [t.detach().clone().requires_grad_() for t in xs]
        ref = attention_ref(*xs, **kw)
        return ref, torch.autograd.grad(ref, xs, grad)

    kernel = kernel_backward(qkv[0])
    with _deterministic():
        o.backward(g)
        ref, a = plain()
        if kernel:
            _, b = plain([t.float() for t in qkv], g.float())
        else:
            _, b = plain()
    o, ref = o.detach(), ref.detach()
    atol, rtol = FLASH_TOL[str(o.dtype)]
    rel = rel_l2(o, ref)
    log(f"train: flash at layer 0's (q, k, v) {tuple(qkv[0].shape)} {o.dtype}: forward max abs "
        f"err {max_err(o, ref)}, relative L2 {rel:.3e} (tolerances {(atol, rtol)}, "
        f"{FLASH_BF16_REL_L2})")
    check(torch.allclose(o.float(), ref.float(), atol=atol, rtol=rtol)
          and rel <= FLASH_BF16_REL_L2, "train: flash forward differs from attention_ref")
    if kernel:
        for nm, t, plain16, want in zip("qkv", leaves, a, b, strict=True):
            got = rel_l2(t.grad, want)
            log(f"train: flash: d{nm} of the backward kernel against the plain vjp in f32: "
                f"relative L2 {got:.3e} (tolerance {FLASH_BWD_REL_L2}; the plain vjp in "
                f"{plain16.dtype}: {rel_l2(plain16, want):.3e})")
            check(t.grad.dtype == plain16.dtype and got <= FLASH_BWD_REL_L2
                  and not torch.isnan(t.grad).any(),
                  f"train: flash: the backward kernel's d{nm} is {got:.3e} from the plain vjp")
    else:
        _same_grads("flash", [t.grad for t in leaves], a, b, "qkv")
    with torch.no_grad():
        fwd_ms = device_ms(lambda: flash_attention_fwd(*qkv, **kw), 20)
    plain_ms = device_ms(lambda: plain(), 3)
    kernel_ms = None
    if kernel:
        with torch.no_grad():
            fo, lse = flash_attention_fwd(*qkv, with_lse=True, **kw)
        kernel_ms = device_ms(lambda: flash_attention_bwd(*qkv, fo, lse, g, **kw), 20)
        log(f"train: flash backward at {tuple(qkv[0].shape)}: kernel {kernel_ms} ms device "
            f"(bound {flash_bwd_bound_ms(qkv[0].shape, qkv[1].shape, kw):.4f} ms), the plain "
            f"vjp {plain_ms} ms")
    return fwd_ms, plain_ms, kernel_ms


def hold_ssd_forward(calls):
    """The SSD kernel at every layer's own inputs (``calls``, one argument
    list a layer) against ``ssd_chunked`` in f32 (``SSD_TOL``): the Function's
    backward is ``ssd_ref``'s autograd by construction, so a kernel fault can
    reach the gradients only through these forwards."""
    import torch

    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_fwd
    from repro_torch.models.mamba2 import ssd_chunked

    worst, bad = [0.0, 0.0], []
    for i, (x, dt, A_log, Bm, Cm, chunk) in enumerate(calls):
        with torch.no_grad():
            y, st = ssd_scan_fwd(x, dt, A_log, Bm, Cm, chunk)
            yr, sr = ssd_chunked(x.float(), dt, A_log, Bm.float(), Cm.float(), chunk)
        atol, rtol = SSD_TOL[str(x.dtype)]
        if not (torch.allclose(y.float(), yr, atol=atol, rtol=rtol)
                and torch.allclose(st, sr, atol=2e-4, rtol=1e-3)):
            bad.append(i)
        worst = [max(worst[0], max_err(y.float(), yr)), max(worst[1], max_err(st, sr))]
    log(f"train: SSD forward at each of {len(calls)} layers' own inputs against ssd_chunked in "
        f"f32: max abs err y {worst[0]}, state {worst[1]}")
    check(not bad, f"train: SSD forward differs from ssd_chunked in layers {bad}")


def hold_ssd_backward(args):
    """The SSD scan at the path's own inputs, as ``hold_flash_backward``:
    forward against ``ssd_chunked`` in f32 (``SSD_TOL``), backward over both
    outputs against ``ssd_ref``'s autograd, bit for bit."""
    import torch

    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_fwd
    from repro_torch.models.mamba2 import ssd_chunked

    *ins, chunk = args
    leaves = [t.detach().clone().requires_grad_() for t in ins]
    y, st = ssd_scan(*leaves, chunk)
    gen = torch.Generator(device="cuda").manual_seed(12)
    gy = torch.randn(y.shape, generator=gen, device="cuda").to(y.dtype)
    gs = torch.randn(st.shape, generator=gen, device="cuda")

    def plain():
        xs = [t.detach().clone().requires_grad_() for t in ins]
        out = ssd_ref(*xs, chunk)
        return out, torch.autograd.grad(out, xs, (gy, gs))

    with _deterministic():
        torch.autograd.backward((y, st), (gy, gs))
        _, a = plain()
        _, b = plain()
    y, st = y.detach(), st.detach()
    x, dt, A_log, Bm, Cm = ins
    yr, sr = ssd_chunked(x.float(), dt, A_log, Bm.float(), Cm.float(), chunk)
    atol, rtol = SSD_TOL[str(x.dtype)]
    log(f"train: SSD at layer 0's inputs x {tuple(x.shape)} {x.dtype}: forward max abs err y "
        f"{max_err(y.float(), yr)}, state {max_err(st, sr)} against ssd_chunked in f32")
    check(torch.allclose(y.float(), yr, atol=atol, rtol=rtol)
          and torch.allclose(st, sr, atol=2e-4, rtol=1e-3), "train: SSD forward differs")
    _same_grads("ssd_scan", [t.grad for t in leaves], a, b, ("x", "dt", "A_log", "Bm", "Cm"))
    with torch.no_grad():
        fwd_ms = device_ms(lambda: ssd_scan_fwd(*ins, chunk), 20)
    bwd_ms = device_ms(lambda: plain(), 3)
    return fwd_ms, bwd_ms


def hold_router_forward(calls):
    """The router kernel at every layer's own logits (``calls``) against
    ``moe_route_ref``: expert ids, ordinals and keep flags bit for bit,
    weights within ``MOE_W_ATOL``."""
    from repro_torch.kernels.moe_route.moe_route import moe_route_fwd
    from repro_torch.kernels.moe_route.ref import moe_route_ref

    worst = 0.0
    for i, (logits, k, capacity, *_) in enumerate(calls):
        got, ref = moe_route_fwd(logits, k, capacity), moe_route_ref(logits, k, capacity)
        for a, b, nm in zip(got[1:], ref[1:], ("idx", "pos", "keep")):
            exact(a, b, f"train: moe_route at layer {i}'s logits {tuple(logits.shape)} {nm}")
        worst = max(worst, max_err(got[0], ref[0]))
    log(f"train: moe_route at each of {len(calls)} layers' own logits "
        f"{tuple(calls[0][0].shape)}, k {calls[0][1]}, capacity {calls[0][2]}: ids, ordinals "
        f"and keep flags bit for bit with moe_route_ref, weights max abs err {worst}")
    check(worst <= MOE_W_ATOL, f"train: moe_route weights max abs err {worst}")


def hold_router_backward(args):
    """The router at the path's own logits: the Function's ``d logits``
    against the autograd of the plain weights ``softmax(logits).gather(1,
    idx) / max(sum, 1e-9)`` at the kernel's experts, bit for bit."""
    import torch

    from repro_torch.kernels.moe_route import moe_route
    from repro_torch.kernels.moe_route.moe_route import moe_route_fwd
    from repro_torch.kernels.moe_route.ops import route_weights

    logits, k, capacity = args[:3]
    leaf = logits.detach().clone().requires_grad_()
    w, idx, _, _ = moe_route(leaf, k, capacity)
    gw = torch.randn(w.shape, generator=torch.Generator(device="cuda").manual_seed(13),
                     device="cuda")

    def plain():
        x = logits.detach().clone().requires_grad_()
        return torch.autograd.grad(route_weights(x, idx), x, gw)

    with _deterministic():
        w.backward(gw)
        a, b = plain(), plain()
    _same_grads("moe_route", [leaf.grad], a, b, ["logits"])
    with torch.no_grad():
        fwd_ms = device_ms(lambda: moe_route_fwd(logits, k, capacity), 20)
    bwd_ms = device_ms(lambda: plain(), 3)
    return fwd_ms, bwd_ms


def step_profile(what, fn):
    """One call of ``fn`` (a train step) after a warm-up one, under
    ``device_busy_ms`` (CUDA activity only: a step is some 10^4–10^5 host
    ops, which CPU tracing would slow tenfold): host ms to the device's
    end, the device's busy ms and idle share, the heaviest kernels logged."""
    fn()
    wall, busy = device_busy_ms(fn, what)
    idle = None if busy is None else max(0.0, 1 - busy / wall)
    log(f"where: {what}: {wall:.3f} ms to the device's end; device busy "
        + (f"{busy:.3f} ms, idle share {idle:.3f}" if busy is not None else
           "not measured (the profiler saw no device time)"))
    return dict(wall_ms=wall, busy_ms=busy, idle=idle)


def _grad_gap(label, g_kernel, g_plain, what="through the kernels"):
    """Logs, not held, how far whole-model gradients ``what`` (by default
    through the kernels) are from those through the plain versions (random
    bf16 stacks are chaotic)."""
    rels = sorted((rel_l2(g_kernel[k], g_plain[k]), k) for k in g_plain)
    log(f"train: {label}: whole-model gradients {what} against the plain versions "
        f"(reported, not held): relative L2 median {rels[len(rels) // 2][0]:.3e}, largest "
        f"{rels[-1][0]:.3e} ({rels[-1][1]}) over {len(rels)} tensors")
    return rels[-1][0]


def model_inputs(batch, cfg):
    """A device batch as the model takes it: audio ``frames``, f32 on the
    host because the pipeline moves numpy, cast to the weights' dtype, as
    ``encdec.encode`` requires."""
    import torch

    if "frames" not in batch:
        return batch
    return dict(batch, frames=batch["frames"].to(getattr(torch, cfg.param_dtype)))


def train_run(label, cfg, B, S, steps, kernel, prepare=None, extra=None, passes=None,
              tokens=None):
    """``cfg`` at full width (random bf16 weights from a seeded generator)
    takes ``steps`` ``bundle.train_step``s on synthetic batches fed by
    ``TrainPipeline`` (each device batch held against its host batch);
    ``extra(i)`` adds numpy inputs to batch ``i`` (a VLM's patches, audio
    frames). ``prepare(bundle, params, batch)``, run first, checks what
    needs the initial weights and returns a report. Checks: ``kernel``
    launched ``passes`` (by default the layers) x steps x 2 times (forward
    and remat's recompute), flash's backward kernel ``passes`` x steps
    times, every loss finite. Reports step ms, tokens/s
    (``tokens`` a batch, by default B x S), peak memory, and one step's
    device busy time and idle share."""
    import gc

    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.data.pipeline import TrainPipeline
    from repro_torch.data.synthetic import synthetic_batches
    from repro_torch.models import build_model

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    opt = bundle.init_opt(params)
    n_params = sum(p.numel() for p in params.parameters())
    it = synthetic_batches(cfg.vocab_size, B, S, 0)
    host = [next(it) for _ in range(steps)]
    for i, hb in enumerate(host):
        hb.update(extra(i) if extra else {})
    first = model_inputs({k: torch.as_tensor(v, device="cuda") for k, v in host[0].items()},
                         cfg)
    log(f"train: {label}: {cfg.name} ({cfg.source}) at full width, {cfg.num_layers} layers, "
        f"{n_params} parameters in {cfg.param_dtype}, moments {cfg.opt_moment_dtype}, remat "
        f"{cfg.remat}, attention {cfg.attn_impl}; B {B} x S {S}, {steps} steps; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    report = prepare(bundle, params, first) if prepare else {}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    pipe = TrainPipeline(iter(host), device="cuda")
    K.reset_launches()
    losses, ms = [], []
    for i, batch in enumerate(pipe):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = bundle.train_step(params, opt, model_inputs(batch, cfg))
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
        for k, v in host[i].items():
            check(torch.equal(batch[k].cpu(), torch.from_numpy(np.ascontiguousarray(v))),
                  f"train: {label}: step {i + 1}'s {k} on the card differs from the host batch")
    pipe.close()
    fns = K.launch_counters()
    launches = {k: fn.launches for k, fn in fns.items()}
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in fns}
    if kernel:
        want[kernel] = (passes or cfg.num_layers) * steps * 2
    if kernel == "flash_attention":  # bf16 flash: one backward kernel a call and step
        want["flash_attention_bwd"] = (passes or cfg.num_layers) * steps
    check(launches == want, f"train: {label}: launches {launches}, expected {want}")
    if kernel == "flash_attention":
        for k in (kernel, "flash_attention_bwd"):
            check(fns[k].launches_by_variant == {"wgmma": want[k]},
                  f"train: {label}: {k} routes {fns[k].launches_by_variant}")
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"train: {label}: losses {losses}")
    step_ms = float(np.median(ms[1:]))
    tokens = tokens or B * S
    where = step_profile(f"{label} train step", lambda: bundle.train_step(params, opt, first))
    log(f"train: {label}: losses {[round(x, 4) for x in losses]}; step ms {[round(x, 1) for x in ms]}"
        f", median after the first {step_ms:.1f} ({tokens / step_ms * 1e3:.0f} tokens/s); peak "
        f"max_memory_allocated {peak / 2**30:.2f} GiB; launches {launches}")
    out = dict(report, steps=steps, losses=losses, step_ms=step_ms,
               tokens_per_s=tokens / step_ms * 1e3, peak_gib=peak / 2**30, launches=launches,
               busy_ms=where["busy_ms"], idle=where["idle"])
    del params, opt, bundle, pipe
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_olmo():
    """OLMo-1B, all 16 layers, bf16, ``remat="full"``, flash."""
    import torch

    import repro_torch.kernels.flash_attention as fpkg
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("olmo-1b").with_overrides(attn_impl="flash")
    chunked = build_model(cfg.with_overrides(attn_impl="chunked"))

    def prepare(bundle, params, batch):
        seen = []
        with torch.no_grad(), _swapped(fpkg, "flash_attention",
                                       _recording(seen, fpkg.flash_attention)):
            bundle.train_loss(params, batch)
        kw = dict(zip(("causal", "window", "softcap", "q_offset"), seen[0][3:7]))
        fwd_ms, bwd_ms, kernel_bwd_ms = hold_flash_backward(seen[0][:3], kw)
        lf, gf = bundle.value_and_grad(params, batch)
        lc, gc_ = chunked.value_and_grad(params, batch)
        rel = abs(float(lf) - float(lc)) / abs(float(lc))
        log(f"train: olmo: step 1's loss through flash {float(lf):.6f}, through the chunked "
            f"attention {float(lc):.6f} from the same weights: relative error {rel:.3e} "
            f"(tolerance {TRAIN_LOSS_REL})")
        check(rel <= TRAIN_LOSS_REL, f"train: olmo: flash and chunked losses differ by {rel}")
        gap = _grad_gap("olmo", gf, gc_)
        return dict(loss_rel=rel, grad_gap=gap, fwd_ms=fwd_ms, bwd_ms=bwd_ms,
                    kernel_bwd_ms=kernel_bwd_ms,
                    first_loss=float(lf))

    B, S, steps = TRAIN_RUNS["olmo"]
    out = train_run("olmo", cfg, B, S, steps, "flash_attention", prepare)
    check(abs(out["losses"][0] - out["first_loss"]) <= 1e-3 * abs(out["first_loss"]),
          f"train: olmo: step 1's loss {out['losses'][0]} is not the loss checked before it "
          f"{out['first_loss']}")
    return out


def _ssd_f32_control(x, dt, A_log, Bm, Cm, chunk):
    """The plain SSD with one rounding changed: ``ssd_chunked`` on f32
    copies of ``x``, ``Bm``, ``Cm``, ``y`` cast back to ``x``'s dtype. Its
    whole-model gradients' distance from the plain path's is what roundings
    alone move them."""
    from repro_torch.models.mamba2 import ssd_chunked

    y, st = ssd_chunked(x.float(), dt, A_log, Bm.float(), Cm.float(), chunk)
    return y.to(x.dtype), st


def train_mamba():
    """Mamba2-780M, all 48 layers, bf16, ``remat="full"``: the SSD scan.
    Whole-model gradients through the kernel are reported against the plain
    path's beside a control, the plain path with one rounding changed
    (``_ssd_f32_control``); every layer's SSD forward is held."""
    import torch

    import repro_torch.kernels.ssd_scan as pkg
    from repro_torch.configs import get_config
    from repro_torch.models.mamba2 import ssd_chunked

    cfg = get_config("mamba2-780m")

    def prepare(bundle, params, batch):
        seen = []
        with torch.no_grad(), _swapped(pkg, "ssd_scan",
                                       _recording(seen, pkg.ssd_scan, cfg.num_layers)):
            bundle.train_loss(params, batch)
        hold_ssd_forward(seen)
        fwd_ms, bwd_ms = hold_ssd_backward(seen[0][:6])
        del seen
        _, gk = bundle.value_and_grad(params, batch)
        with _swapped(pkg, "ssd_scan", ssd_chunked):
            _, gp = bundle.value_and_grad(params, batch)
        gap = _grad_gap("mamba", gk, gp)
        del gk
        with _swapped(pkg, "ssd_scan", _ssd_f32_control):
            _, gc_ = bundle.value_and_grad(params, batch)
        control = _grad_gap("mamba", gc_, gp, "through the control (ssd_chunked on f32 "
                            "copies, y cast back)")
        return dict(grad_gap=gap, control_gap=control, fwd_ms=fwd_ms, bwd_ms=bwd_ms)

    B, S, steps = TRAIN_RUNS["mamba"]
    return train_run("mamba", cfg, B, S, steps, "ssd_scan", prepare)


def train_mixtral():
    """Mixtral-8x7B at full width, ``MIXTRAL_TRAIN_LAYERS`` of its 32 layers:
    the router in every layer's FFN (its attention is the config's chunked
    one). The router's weights must carry gradient beyond the aux loss's:
    the router tensors' gradient of the cross-entropy alone (the aux
    coefficient at 0) is non-zero."""
    import torch

    import repro_torch.kernels.moe_route as pkg
    from repro_torch.configs import get_config
    from repro_torch.models.layers import lm_loss
    from repro_torch.models.transformer import head_matrix, lm_forward

    full = get_config("mixtral-8x7b")
    cfg = full.with_overrides(num_layers=MIXTRAL_TRAIN_LAYERS)

    def prepare(bundle, params, batch):
        seen = []
        with torch.no_grad(), _swapped(pkg, "moe_route",
                                       _recording(seen, pkg.moe_route, cfg.num_layers)):
            bundle.train_loss(params, batch)
        hold_router_forward(seen)
        fwd_ms, bwd_ms = hold_router_backward(seen[0])
        routers = [lp.ffn.router for lp in params.layers]
        g_full = torch.autograd.grad(bundle.train_loss(params, batch), routers)
        h, _aux = lm_forward(params, batch["tokens"], cfg)
        ce = lm_loss(h, head_matrix(params, cfg), batch["labels"], cfg.loss_chunk)
        g_ce = torch.autograd.grad(ce, routers)
        norms = [(float(a.norm()), float(b.norm())) for a, b in zip(g_ce, g_full)]
        log(f"train: mixtral: router gradient norms per layer, cross-entropy alone (aux "
            f"coefficient 0) against the whole loss: {norms}")
        check(all(a > 0 for a, _ in norms), "train: mixtral: the router's weights carry no "
              "gradient beyond the aux loss's")
        return dict(fwd_ms=fwd_ms, bwd_ms=bwd_ms, router_grad_norms=norms)

    B, S, steps = TRAIN_RUNS["mixtral"]
    return train_run("mixtral", cfg, B, S, steps, "moe_route", prepare)


#: InternVL2-1B's train cell (the JAX VLM train cell's split of S = 2048):
#: batch, patches of width ``VIT_DIM``, text tokens, steps
INTERNVL_TRAIN = (4, 256, 1792, 6)
#: Whisper-tiny's train cell: batch, decoder tokens (Whisper's published
#: decoder length), steps; ``WHISPER_TRAIN_ENC`` frames a clip
WHISPER_TRAIN = (8, 448, 6)
#: Jamba's gradient at full width: one block (``JAMBA_LAYERS``) with
#: ``JAMBA_TRAIN_EXPERTS`` experts a MoE slot, one ``bundle.value_and_grad``
#: at (B, S) = ``JAMBA_TRAIN``, no optimizer step: 4 experts are 16.15e9
#: parameters (30.1 GiB in bf16) and the gradients as much again; even 2
#: experts (11.32e9) need some 90 GB with bf16 weights, gradients and Jamba's
#: bf16 moments, so no full-width cut takes an Adam step on one card
JAMBA_TRAIN_EXPERTS = 4
JAMBA_TRAIN = (1, 2048)
#: the reckoned peak above which the Jamba gradient's S is halved
JAMBA_TRAIN_PEAK_GIB = 76


def train_internvl():
    """InternVL2-1B, whole, bf16, ``remat="full"``, flash: batches of
    ``INTERNVL_TRAIN`` (256 f32 patches prepended to 1792 tokens, S = 2048,
    no loss on the prefix). Flash's Function at layer 0's own inputs:
    forward against ``attention_ref``, the backward kernel against its
    autograd in f32 (``FLASH_BWD_REL_L2``)."""
    import numpy as np
    import torch

    import repro_torch.kernels.flash_attention as fpkg
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import VIT_DIM

    cfg = get_config("internvl2-1b").with_overrides(attn_impl="flash")
    B, P, S, steps = INTERNVL_TRAIN

    def patches(i):
        rng = np.random.default_rng(100 + i)
        return {"patches": rng.standard_normal((B, P, VIT_DIM), dtype=np.float32)}

    def prepare(bundle, params, batch):
        seen = []
        with torch.no_grad(), _swapped(fpkg, "flash_attention",
                                       _recording(seen, fpkg.flash_attention)):
            bundle.train_loss(params, batch)
        check(seen[0][0].shape[2] == P + S, f"train: internvl: flash saw Sq "
              f"{seen[0][0].shape[2]}, expected {P + S} (patches + tokens)")
        kw = dict(zip(("causal", "window", "softcap", "q_offset"), seen[0][3:7]))
        fwd_ms, bwd_ms, kernel_bwd_ms = hold_flash_backward(seen[0][:3], kw)
        return dict(fwd_ms=fwd_ms, bwd_ms=bwd_ms, kernel_bwd_ms=kernel_bwd_ms)

    return train_run("internvl", cfg, B, S, steps, "flash_attention", prepare, extra=patches,
                     tokens=B * (P + S))


def train_whisper():
    """Whisper-tiny, whole (4 encoder, 4 decoder layers), bf16, ``remat=
    "full"``, flash: batches of ``WHISPER_TRAIN`` with ``frames`` (B,
    ``WHISPER_TRAIN_ENC``, D) of bf16 values (f32 on the host: the pipeline
    moves numpy; cast to bf16 on the card by ``model_inputs``), 12 flash
    calls a forward. The cross-attention Function
    (decoder layer 0) at its own inputs: forward against ``attention_ref``,
    the backward kernel against its autograd in f32 (``FLASH_BWD_REL_L2``)."""
    import numpy as np
    import torch

    import repro_torch.kernels.flash_attention as fpkg
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import WHISPER_TRAIN_ENC

    cfg = get_config("whisper-tiny").with_overrides(attn_impl="flash")
    B, S, steps = WHISPER_TRAIN
    passes = cfg.enc_layers + 2 * cfg.num_layers

    def frames(i):
        g = torch.Generator().manual_seed(200 + i)
        x = torch.randn((B, WHISPER_TRAIN_ENC, cfg.d_model), generator=g)
        return {"frames": x.to(torch.bfloat16).float().numpy()}

    def prepare(bundle, params, batch):
        seen = []
        with torch.no_grad(), _swapped(fpkg, "flash_attention",
                                       _recording(seen, fpkg.flash_attention, passes)):
            bundle.train_loss(params, batch)
        cross = seen[cfg.enc_layers + 1]
        check(cross[1].shape[2] == WHISPER_TRAIN_ENC and cross[0].shape[2] == S
              and not cross[3], f"train: whisper: the cross call has q "
              f"{tuple(cross[0].shape)}, k {tuple(cross[1].shape)}, causal {cross[3]}")
        kw = dict(zip(("causal", "window", "softcap", "q_offset"), cross[3:7]))
        fwd_ms, bwd_ms, kernel_bwd_ms = hold_flash_backward(cross[:3], kw)
        return dict(fwd_ms=fwd_ms, bwd_ms=bwd_ms, kernel_bwd_ms=kernel_bwd_ms)

    return train_run("whisper", cfg, B, S, steps, "flash_attention", prepare, extra=frames,
                     passes=passes, tokens=B * (WHISPER_TRAIN_ENC + S))


def jamba_grad_peak_gib(n_params, cfg, B, S):
    """The reckoned peak of Jamba's ``value_and_grad``: weights and gradients
    in bf16 (4 B a parameter), and the block's activations, held from its
    recompute (remat full) through its backward, per token: each MoE slot's
    (E, C, F) gate, up, product and SiLU at 2.5 rows a token (capacity 1.25
    x top-2) in bf16, each mixer's in_proj output, conv and gate some five
    times its 2·d_inner + 2·N + H columns in bf16, each dense MLP's three
    (F,) rows, and the f32 logits, their softmax and gradient; plus one
    mixer's plain SSD backward (ssd_ref's autograd, some five (chunk,
    chunk, H) f32 tensors a chunk)."""
    F, V = cfg.d_ff, cfg.vocab_size
    cols = 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
    per_token = 4 * 2.5 * F * 2 * 4 + 7 * cols * 2 * 5 + 4 * 3 * F * 2 + 3 * V * 4
    chunks = -(-S // cfg.ssm_chunk)
    ssd = B * chunks * 5 * cfg.ssm_chunk ** 2 * cfg.ssm_heads * 4
    return (4 * n_params + B * S * per_token + ssd) / 2**30


def train_jamba():
    """Jamba-1.5-Large at full width, one block (``JAMBA_LAYERS``) with
    ``JAMBA_TRAIN_EXPERTS`` experts a MoE slot: one ``bundle.value_and_grad``
    at ``JAMBA_TRAIN``, ``remat="full"``, flash, no optimizer step (see
    ``JAMBA_TRAIN_EXPERTS``). The peak is reckoned first
    (``jamba_grad_peak_gib``); above ``JAMBA_TRAIN_PEAK_GIB`` S is halved.
    Holds, at the block's own inputs (a no-grad forward first): the SSD
    forward at all 7 mixers and the router at all 4 MoE slots against their
    plain versions, and the three Functions' backwards (flash at the
    attention slot, the SSD at the first mixer, the router at the first MoE
    slot) against the plain versions' autograd (flash's backward kernel
    within ``FLASH_BWD_REL_L2``, the others bit for bit). Checks: flash
    launched 1 x 2 and its backward kernel once, the SSD 7 x 2, the router
    4 x 2 (forward and remat's recompute), a finite loss and gradient. Reports the call's ms and the
    peak."""
    import gc

    import numpy as np
    import torch

    import repro_torch.kernels.flash_attention as fpkg
    import repro_torch.kernels.moe_route as mpkg
    import repro_torch.kernels.ssd_scan as spkg
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TrainPipeline
    from repro_torch.data.synthetic import synthetic_batches
    from repro_torch.models import build_model
    from repro_torch.models.model_zoo import analytic_param_count

    full = get_config("jamba-1.5-large-398b")
    cfg = full.with_overrides(num_layers=JAMBA_LAYERS, num_experts=JAMBA_TRAIN_EXPERTS,
                              attn_impl="flash")
    B, S = JAMBA_TRAIN
    n = analytic_param_count(cfg)
    est = jamba_grad_peak_gib(n, cfg, B, S)
    log(f"train: jamba: {n} parameters ({n * 2 / 2**30:.2f} GiB in bf16); reckoned peak at "
        f"{B} x {S}: {est:.2f} GiB (limit {JAMBA_TRAIN_PEAK_GIB})")
    while est > JAMBA_TRAIN_PEAK_GIB:
        S //= 2
        est = jamba_grad_peak_gib(n, cfg, B, S)
        log(f"train: jamba: S halved to {S} (the cut): reckoned peak {est:.2f} GiB")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bundle = build_model(cfg)
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"train: jamba: {cfg.name} ({cfg.source}) at full width, {cfg.num_layers} of its "
        f"{full.num_layers} layers with {cfg.num_experts} of its {full.num_experts} experts, "
        f"remat {cfg.remat}, attention {cfg.attn_impl}; initialised in "
        f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    pipe = TrainPipeline(synthetic_batches(cfg.vocab_size, B, S, 0), device="cuda")
    batch = next(iter(pipe))
    pipe.close()

    flash, ssd, route = [], [], []
    with torch.no_grad(), \
            _swapped(fpkg, "flash_attention", _recording(flash, fpkg.flash_attention)), \
            _swapped(spkg, "ssd_scan", _recording(ssd, spkg.ssd_scan, 7)), \
            _swapped(mpkg, "moe_route", _recording(route, mpkg.moe_route, 4)):
        bundle.train_loss(params, batch)
    check(len(flash) == 1 and len(ssd) == 7 and len(route) == 4,
          f"train: jamba: the forward made {len(flash)}, {len(ssd)}, {len(route)} kernel calls")
    hold_ssd_forward(ssd)
    hold_router_forward(route)
    kw = dict(zip(("causal", "window", "softcap", "q_offset"), flash[0][3:7]))
    report = {}
    report["flash_fwd_ms"], report["flash_bwd_ms"], report["flash_kernel_bwd_ms"] = \
        hold_flash_backward(flash[0][:3], kw)
    report["ssd_fwd_ms"], report["ssd_bwd_ms"] = hold_ssd_backward(ssd[0][:6])
    report["route_fwd_ms"], report["route_bwd_ms"] = hold_router_backward(route[0])
    del flash, ssd, route
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    K.reset_launches()
    (loss, grads), ms = timed(lambda: bundle.value_and_grad(params, batch))
    fns = K.launch_counters()
    launches = {k: fn.launches for k, fn in fns.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {**{k: 0 for k in fns}, "flash_attention": 2, "flash_attention_bwd": 1,
            "ssd_scan": 14, "moe_route": 8}
    check(launches == want, f"train: jamba: launches {launches}, expected {want}")
    finite = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all())
                                                for g in grads.values())
    check(finite, "train: jamba: the loss or a gradient is not finite")
    norm = float(torch.stack([g.float().norm() for g in grads.values()]).norm())
    log(f"train: jamba: value_and_grad at {B} x {S}: loss {float(loss):.4f}, gradient norm "
        f"{norm:.4e}, every gradient finite; {ms:.1f} ms ({B * S / ms * 1e3:.0f} tokens/s); "
        f"peak max_memory_allocated {peak:.2f} GiB (reckoned {est:.2f}); launches {launches}")
    out = dict(report, steps=1, losses=[float(loss)], step_ms=ms,
               tokens_per_s=B * S / ms * 1e3, peak_gib=peak, reckoned_gib=est, seq=S,
               launches=launches, busy_ms=None, idle=None, fwd_ms=report["flash_fwd_ms"],
               bwd_ms=report["flash_bwd_ms"], kernel_bwd_ms=report["flash_kernel_bwd_ms"])
    del params, grads, bundle, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _hybrid_example():
    spec = importlib.util.spec_from_file_location(
        "torch_hybrid_train", os.path.join(HERE, "examples", "torch_hybrid_train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def train_hybrid():
    """The paper's hybrid training app (``examples/torch_hybrid_train.py``):
    the dataflow phase on a ``cuda`` worker, then ``launch.train.train`` of
    ``ignis-100m`` on the corpus with checkpoints at the middle step and the
    end; the checkpoint restores bit for bit; a second call with more steps
    resumes from the latest step and its steps advance. No kernel runs on
    this path (the config's chunked attention; the dataflow phase filters
    and collects)."""
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch

    import repro_torch.launch.train as T
    from repro_torch import kernels as K
    from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.configs import get_config
    from repro_torch.core import ICluster, IProperties, IWorker
    from repro_torch.models import build_model

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ex = _hybrid_example()
    h = TRAIN_HYBRID
    K.reset_launches()
    w = IWorker(ICluster(IProperties({"ignis.device": "cuda"})), "python")
    ids, n_docs, rows = ex.dataflow_phase(w, h["seq_len"])
    log(f"train: hybrid: dataflow filter kept {len(ids)}/{n_docs} docs; packed "
        f"{rows.shape[0]} rows of {rows.shape[1]}")
    times, first_batch = [], []
    real = T.make_train_step

    def timed_step(*a, **kw):
        step = real(*a, **kw)

        def run(params, opt, ef, batch):
            if not first_batch:
                first_batch.append(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(params, opt, ef, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        ckpt = os.path.join(root, "ckpt")
        with _swapped(T, "make_train_step", timed_step):
            params, opt, losses = ex.train_phase("ignis-100m", h["steps"], h["batch"],
                                                 h["seq_len"], ckpt, "cuda")
        peak = torch.cuda.max_memory_allocated()
        first, last = losses[0][1], losses[-1][1]
        check(last < first, f"train: hybrid: loss {first} -> {last} did not fall")
        steps_saved = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt))
        check(steps_saved == [h["steps"] // 2, h["steps"]],
              f"train: hybrid: checkpoints at {steps_saved}")
        saved = T.checkpoint_tree(params, opt)
        back = restore(ckpt, h["steps"], T.checkpoint_tree(params, opt, lambda t: t.to("meta")),
                       "cpu")
        flat_a, flat_b = _flatten(saved), _flatten(back)
        check(flat_a.keys() == flat_b.keys() and all(
            flat_a[k].dtype == flat_b[k].dtype and torch.equal(flat_a[k], flat_b[k])
            for k in flat_a), "train: hybrid: the restored tree differs from the saved one")
        nbytes = sum(t.numel() * t.element_size() for t in flat_a.values())
        t0 = time.perf_counter()
        ck = AsyncCheckpointer(os.path.join(root, "timed"))
        ck.save(1, T.checkpoint_tree(params, opt))
        ck.wait()
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        T.restore_checkpoint(os.path.join(root, "timed"), 1, params, opt)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        _, _, losses2 = ex.train_phase("ignis-100m", h["more"], h["batch"], h["seq_len"], ckpt,
                                       "cuda")
        check(losses2 and losses2[0][0] > h["steps"] and losses2[-1][0] == h["more"]
              and latest_step(ckpt) == h["more"],
              f"train: hybrid: the resumed run logged steps {[s for s, _ in losses2]}, latest "
              f"checkpoint {latest_step(ckpt)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    fns = K.launch_counters()
    launched = {k: fn.launches for k, fn in fns.items() if fn.launches}
    check(not launched, f"train: hybrid: kernels launched on a kernel-free path: {launched}")
    step_ms = float(np.median(times[1:]))
    tokens = h["batch"] * h["seq_len"]
    cfg = get_config("ignis-100m")
    step = real(build_model(cfg), cfg)
    where = step_profile("hybrid train step", lambda: step(params, opt, None, first_batch[0]))
    log(f"train: hybrid: ignis-100m, {h['steps']} steps of {h['batch']} x {h['seq_len']}: loss "
        f"{first:.4f} -> {last:.4f} (logged {losses}); step ms median after the first "
        f"{step_ms:.2f} ({tokens / step_ms * 1e3:.0f} tokens/s); peak max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; checkpoint of {nbytes} B: save {save_ms:.1f} ms "
        f"({nbytes / save_ms / 1e6:.3f} GB/s), restore {restore_ms:.1f} ms "
        f"({nbytes / restore_ms / 1e6:.3f} GB/s); resumed to step {h['more']}: "
        f"{losses2}; no kernel launched")
    return dict(steps=h["steps"], losses=losses, step_ms=step_ms,
                tokens_per_s=tokens / step_ms * 1e3, peak_gib=peak / 2**30,
                save_ms=save_ms, restore_ms=restore_ms, ckpt_bytes=nbytes,
                busy_ms=where["busy_ms"], idle=where["idle"])


#: the train run that launches each model kernel
TRAIN_KERNEL_RUN = {"flash_attention": "olmo", "ssd_scan": "mamba", "moe_route": "mixtral"}
#: the model kernels, whose kernels-line rows carry the family phases'
#: launches (``family_launches``), and the family train runs among them
MODEL_KERNELS = tuple(TRAIN_KERNEL_RUN)
FAMILY_TRAIN_RUNS = ("internvl", "whisper", "jamba")


def train_phase():
    """The training path at full width: the hybrid app, then OLMo-1B
    (flash), Mamba2-780M (the SSD scan) and Mixtral-8x7B at
    ``MIXTRAL_TRAIN_LAYERS`` layers (the router), then InternVL2-1B (flash
    over the patch prefix), Whisper-tiny (flash: encoder, decoder self and
    cross) and Jamba's gradient (all three kernels). Returns each run's
    report; ``launches`` of each model run are its kernels' training
    launches."""
    t0 = time.perf_counter()
    out = {"hybrid": train_hybrid(), "olmo": train_olmo(), "mamba": train_mamba(),
           "mixtral": train_mixtral()}
    for label, run in (("internvl", train_internvl), ("whisper", train_whisper),
                       ("jamba", train_jamba)):
        t1 = time.perf_counter()
        out[label] = run()
        log(f"train: {label}: run took {time.perf_counter() - t1:.1f} s")
    for label, r in out.items():
        log(f"train: {label}: step {r['step_ms']:.2f} ms, {r['tokens_per_s']:.0f} tokens/s, "
            f"peak {r['peak_gib']:.2f} GiB, one step's device busy {r['busy_ms']} ms, idle share "
            f"{r['idle']}" + (f"; forward kernel {r['fwd_ms']} ms device against the plain "
                              f"backward's {r['bwd_ms']} ms" if "fwd_ms" in r else "")
            + (f", the backward kernel {r['kernel_bwd_ms']} ms" if r.get("kernel_bwd_ms")
               else ""))
    log(f"train: phase took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 8: distributed — expert-parallel MoE, the pipeline schedule and
# restore_elastic on meshes of virtual ranks
# ---------------------------------------------------------------------------

#: Phi-3.5-MoE's EP prefill, (batch, tokens), on a (data, model) mesh of
#: ``EP_MESH``: T_loc = 2048 tokens a data rank, E_loc = 2 experts a rank,
#: so C = int(1.25 x 2048 x 2 / 16) = 320 per (source rank, expert)
EP_PREFILL = (8, 2048)
EP_MESH = (8, 1)
#: the no-drop check (capacity factor 8) runs on layer 0's own inputs cut
#: to this many positions a row (T_loc = 1024, so C = 1024 = T_loc: no
#: assignment can drop): at 2048 its (16, 16384, 6400) bf16 products, three
#: of them, do not fit beside 24 layers' weights
EP_NODROP_POSITIONS = 1024
#: OLMo-1B whole, its 16 layers as ``PIPE_STAGES`` stages, ``PIPE_MICRO``
#: microbatches of 1 x ``PIPE_SEQ`` tokens
PIPE_STAGES, PIPE_MICRO, PIPE_SEQ = 4, 8, 2048
#: restore_elastic: OLMo-1B's params and AdamW state after one
#: ``bundle.train_step`` at 1 x 2048 (11.8 GB), saved under
#: ``ELASTIC_SAVE_MESH`` (the config's own dp preset), the params restored
#: under each (mesh, preset): with the moments the phase took over a minute
#: (a whole restore 21.6–26.9 s on an NVIDIA H100 80GB HBM3 at 700 W;
#: PERF.md §4), so the moments' placement is reckoned by ``opt_specs``
ELASTIC_SAVE_MESH = (8, 1)
ELASTIC_RESTORES = (((4, 2), "fsdp_tp_zero1"), ((5, 1), "fsdp_tp_zero1"))


def _drops(routes):
    """Assignments a router call's keep flags drop."""
    return sum(int((~out[3]).sum()) for *_a, out in routes)


def dist_ep(gpu):
    """Phi-3.5-MoE at full width and ``PHI_LAYERS`` layers, ``moe_ep=True``,
    flash, random bf16 weights: one prefill of ``EP_PREFILL`` under
    ``make_local_mesh(*EP_MESH)``. Checks: EP taken in every layer, the
    router launched once per data rank in each (and flash once a layer, no
    other kernel), the router at each of its own logits against
    ``moe_route_ref`` (ids, ordinals, keep bit for bit, weights within
    ``MOE_W_ATOL``), each layer's EP output at its own inputs against the
    same EP function with the router's plain version (``MOE_REL_L2``), the
    EP layer at capacity factor 8 against the flat ``moe_ffn_bsd`` on layer
    0's inputs (``MOE_REL_L2`` over the tokens both route alike; the tokens
    routed otherwise, by the router products' roundings at other row
    counts, counted and held under 0.1 %), finite logits. Reports the EP
    prefill against the flat one, the assignments dropped, and each rank's
    parameter bytes by ``param_specs``."""
    import gc

    import torch

    import repro_torch.kernels.moe_route as pkg
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import param_specs, rank_bytes, to_named
    from repro_torch.interop import reference_tree
    from repro_torch.kernels.moe_route.ref import moe_route_ref
    from repro_torch.launch.mesh import make_local_mesh, use_mesh
    from repro_torch.models import build_model, moe_ep
    from repro_torch.models.moe import capacity_for, moe_ffn_bsd

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full = get_config("phi3.5-moe-42b-a6.6b")
    cfg = full.with_overrides(num_layers=PHI_LAYERS, attn_impl="flash", moe_ep=True)
    bundle = build_model(cfg)
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    mesh = make_local_mesh(*EP_MESH)
    B, S = EP_PREFILL
    p, E, L = mesh.shape["data"], cfg.num_experts, cfg.num_layers
    T_loc = B // p * S
    C = moe_ep.capacity_ep(cfg, T_loc)
    tree = reference_tree(params, leaf=lambda t: t.to("meta"))
    per_rank = rank_bytes(to_named(param_specs(tree, cfg, mesh), mesh, tree))
    whole = sum(t.numel() * t.element_size() for t in params.parameters())
    log(f"distributed: ep: {cfg.name} at full width, {L} of its {full.num_layers} layers, "
        f"{E} experts top-{cfg.experts_per_token}, preset {cfg.sharding_preset}, on {mesh}: "
        f"E_loc {E // p}, T_loc {T_loc}, C {C} per (source, expert) at capacity factor "
        f"{cfg.capacity_factor}; parameters {whole} B whole, {per_rank} B a rank by "
        f"param_specs; initialised in {time.perf_counter() - t0:.1f} s ({gpu})")
    tokens = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))

    # each EP layer, as it runs, against the same function with the router's
    # plain version at its own inputs (the plain router launches nothing);
    # the flat path's drops at the same inputs; layer 0's inputs kept
    routes, first = [], []
    held = {"layers": 0, "rel": 0.0, "abs": 0.0, "aux": 0.0, "flat_drop": 0}
    real_ep, real_route = moe_ep.moe_ffn_bsd_ep, pkg.moe_route

    def plain(logits, k, capacity, *a):
        return moe_route_ref(logits, k, capacity)

    def ep_held(x, prm, c, axis="data"):
        y, aux = real_ep(x, prm, c, axis)
        with _swapped(pkg, "moe_route", plain):
            yp, auxp = real_ep(x, prm, c, axis)
        held["layers"] += 1
        held["rel"] = max(held["rel"], rel_l2(y, yp))
        held["abs"] = max(held["abs"], max_err(y, yp))
        held["aux"] = max(held["aux"], abs(float(aux) - float(auxp)))
        lg = x.reshape(-1, x.shape[-1]).float() @ prm.router
        held["flat_drop"] += int((~moe_route_ref(lg, c.experts_per_token,
                                                 capacity_for(c, lg.shape[0]))[3]).sum())
        if not first:
            first.append((x[:, :EP_NODROP_POSITIONS].clone(), prm))
        return y, aux

    def route_recording(logits, k, capacity, *a):
        out = real_route(logits, k, capacity, *a)
        routes.append((logits, k, capacity, out))
        return out

    K.reset_launches()
    with use_mesh(mesh), _swapped(moe_ep, "moe_ffn_bsd_ep", ep_held), \
            _swapped(pkg, "moe_route", route_recording):
        logits, cache = bundle.prefill(params, tokens=tokens)
    torch.cuda.synchronize()
    fns = K.launch_counters()
    launches = {k: fn.launches for k, fn in fns.items()}
    want = {k: 0 for k in fns}
    want.update(moe_route=L * p, flash_attention=L)
    log(f"distributed: ep: one prefill of {B} x {S} tokens: EP layers {held['layers']} of "
        f"{L}, router calls {len(routes)} (geometries "
        f"{sorted({(tuple(r[0].shape), r[1], r[2]) for r in routes})}), launches {launches} "
        f"(expected {want})")
    check(held["layers"] == L, f"distributed: ep: EP taken in {held['layers']} of {L} layers")
    check(launches == want, f"distributed: ep: launches {launches}, expected {want}")
    check(fns["flash_attention"].launches_by_variant == {"wgmma": L},
          f"distributed: ep: flash routes {fns['flash_attention'].launches_by_variant}")
    check(all(tuple(r[0].shape) == (T_loc, E) and r[2] == C for r in routes),
          "distributed: ep: a router call not at one rank's (T_loc, E) and C")
    check(bool(torch.isfinite(logits).all()), "distributed: ep: non-finite logits")
    del cache

    worst_w = 0.0
    for i, (lg, k, c, out) in enumerate(routes):
        ref = moe_route_ref(lg, k, c)
        for a, b, nm in zip(out[1:], ref[1:], ("idx", "pos", "keep")):
            exact(a, b, f"distributed: ep: moe_route at call {i} {nm}")
        worst_w = max(worst_w, max_err(out[0], ref[0]))
    check(worst_w <= MOE_W_ATOL, f"distributed: ep: router weights max abs err {worst_w}")
    log(f"distributed: ep: the router at each of its {len(routes)} calls' own logits: ids, "
        f"ordinals, keep bit for bit with moe_route_ref, weights max abs err {worst_w}; each "
        f"layer's EP output at its own inputs against EP with the plain router: relative L2 "
        f"at most {held['rel']:.3e}, max abs err {held['abs']}, aux {held['aux']} "
        f"(tolerance {MOE_REL_L2})")
    check(held["rel"] <= MOE_REL_L2 and held["aux"] <= 1e-6,
          f"distributed: ep: EP through the kernel differs from EP with the plain router "
          f"{held}")
    ep_drop, flat_drop = _drops(routes), held["flat_drop"]
    n_assign = L * B * S * cfg.experts_per_token

    # no drops (capacity factor 8): EP against the flat path on layer 0's inputs
    x0, p0 = first[0]
    del routes, first
    gc.collect()
    torch.cuda.empty_cache()
    cfg8 = cfg.with_overrides(capacity_factor=8.0)
    seen = {"ep": [], "flat": []}

    def tagged(tag):
        def route(logits, k, capacity, *a):
            out = real_route(logits, k, capacity, *a)
            seen[tag].append(out)
            return out
        return route

    with torch.no_grad():
        with use_mesh(mesh), _swapped(pkg, "moe_route", tagged("ep")):
            y_ep, _ = moe_ep.moe_ffn_bsd_ep(x0, p0, cfg8)
        with _swapped(pkg, "moe_route", tagged("flat")):
            y_flat, _ = moe_ffn_bsd(x0, p0, cfg8)
    ids_ep = torch.cat([o[1] for o in seen["ep"]]).sort(-1).values
    ids_flat = seen["flat"][0][1].sort(-1).values
    alike = (ids_ep == ids_flat).all(-1)
    moved = int((~alike).sum())
    drops8 = _drops([(None, o) for o in seen["ep"]]), _drops([(None, o) for o in seen["flat"]])
    y_ep, y_flat = y_ep.reshape(-1, y_ep.shape[-1]), y_flat.reshape(-1, y_flat.shape[-1])
    rel8, err8 = rel_l2(y_ep[alike], y_flat[alike]), max_err(y_ep[alike], y_flat[alike])
    log(f"distributed: ep: capacity factor 8 on layer 0's inputs ({B} x "
        f"{EP_NODROP_POSITIONS}): EP against the flat moe_ffn_bsd: dropped {drops8} "
        f"(EP, flat), tokens routed otherwise {moved} of {alike.numel()}, over the rest "
        f"relative L2 {rel8:.3e}, max abs err {err8} (tolerance {MOE_REL_L2})")
    check(drops8 == (0, 0), f"distributed: ep: drops at capacity factor 8: {drops8}")
    check(moved * 1000 <= alike.numel() and rel8 <= MOE_REL_L2,
          f"distributed: ep: EP and the flat path differ at no drops: moved {moved}, "
          f"relative L2 {rel8}")
    del x0, y_ep, y_flat, seen

    with torch.no_grad():
        with use_mesh(mesh):
            ep_ms = time_ms(lambda: bundle.prefill(params, tokens=tokens), 3)
        flat_ms = time_ms(lambda: bundle.prefill(params, tokens=tokens), 3)
        with use_mesh(mesh):
            ep_ms2 = time_ms(lambda: bundle.prefill(params, tokens=tokens), 3)
    peak = torch.cuda.max_memory_allocated()
    log(f"distributed: ep: prefill of {B} x {S} tokens (CUDA events, 3 calls each, EP, flat, "
        f"EP): EP {ep_ms:.3f} ms and {ep_ms2:.3f} ms, flat {flat_ms:.3f} ms "
        f"({B * S / ep_ms * 1e3:.0f} and {B * S / flat_ms * 1e3:.0f} tokens/s); assignments "
        f"dropped at capacity factor {cfg.capacity_factor} on the EP run's layer inputs: EP "
        f"{ep_drop}, flat {flat_drop} of {n_assign}; peak max_memory_allocated "
        f"{peak / 2**30:.2f} GiB ({gpu})")
    del params, bundle, logits
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, ep_ms=[ep_ms, ep_ms2], flat_ms=flat_ms, ep_dropped=ep_drop,
                flat_dropped=flat_drop, assignments=n_assign, rank_param_bytes=per_rank,
                param_bytes=whole, peak_gib=peak / 2**30, router_w_err=worst_w,
                layer_rel_l2=held["rel"], nodrop_rel_l2=rel8, nodrop_moved=moved)


def olmo_stage_fn(cfg):
    """One pipeline stage of a dense transformer: its layers (an
    ``nn.ModuleList``) in order, as ``transformer.lm_prefill`` runs them."""
    import torch

    from repro_torch.models import attention as attn
    from repro_torch.models.layers import apply_norm, mlp
    from repro_torch.models.transformer import layer_windows

    window = int(layer_windows(cfg)[0])

    def fn(stage, x):
        B, S, _ = x.shape
        pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        for lp in stage:
            a, _ = attn.attention(apply_norm(x, lp.ln1, cfg.norm_type), lp.attn, cfg, pos,
                                  window=window, static_window=True)
            x = x + a
            x = x + mlp(apply_norm(x, lp.ln2, cfg.norm_type), lp.ffn)
        return x

    return fn


def dist_pipeline(gpu):
    """OLMo-1B whole (16 layers, flash, random bf16 weights) as
    ``PIPE_STAGES`` stages under ``make_pp_mesh(PIPE_STAGES)``,
    ``PIPE_MICRO`` microbatches of 1 x ``PIPE_SEQ``: ``pipeline_apply``
    against ``reference_apply`` bit for bit (the same kernels on the same
    inputs in the same order: every flash call and product has the
    microbatch's shape), flash launched once a layer and microbatch in each
    (the bubble ticks run no stage), finite logits; both timed."""
    import gc

    import torch

    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.distributed.pipeline import pipeline_apply, reference_apply
    from repro_torch.launch.mesh import make_pp_mesh
    from repro_torch.models import build_model
    from repro_torch.models.layers import apply_norm
    from repro_torch.models.transformer import embed_tokens, head_matrix

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("olmo-1b").with_overrides(attn_impl="flash")
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    L, S_, M = cfg.num_layers, PIPE_STAGES, PIPE_MICRO
    per = L // S_
    stages = torch.nn.ModuleList(torch.nn.ModuleList(params.layers[s * per:(s + 1) * per])
                                 for s in range(S_))
    mesh = make_pp_mesh(S_)
    fn = olmo_stage_fn(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (M, 1, PIPE_SEQ), dtype=torch.int32,
                           device="cuda", generator=torch.Generator(device="cuda").manual_seed(2))
    counts = {}
    with torch.no_grad():
        x = torch.stack([embed_tokens(params, t, cfg) for t in tokens])
        for label, run in (("pipeline", lambda: pipeline_apply(stages, x, fn, mesh)),
                           ("reference", lambda: reference_apply(stages, x, fn))):
            K.reset_launches()
            out = run()
            torch.cuda.synchronize()
            counts[label] = ({k: f.launches for k, f in K.launch_counters().items()}, out)
        (got_n, got), (ref_n, ref) = counts["pipeline"], counts["reference"]
        want = {k: 0 for k in got_n}
        want["flash_attention"] = M * L
        h = apply_norm(got[:, 0, -1], params.final_norm, cfg.norm_type)
        logits = h @ head_matrix(params, cfg)
        pipe_ms = time_ms(lambda: pipeline_apply(stages, x, fn, mesh), 2)
        ref_ms = time_ms(lambda: reference_apply(stages, x, fn), 2)
    same = torch.equal(got, ref)
    log(f"distributed: pipeline: {cfg.name} whole ({L} layers, flash) as {S_} stages of "
        f"{per} on {mesh}, {M} microbatches of 1 x {PIPE_SEQ}: pipeline_apply against "
        f"reference_apply bit for bit {same} (max abs err {max_err(got, ref)}); launches "
        f"pipeline {got_n}, reference {ref_n} (expected {want}); pipeline {pipe_ms:.3f} ms, "
        f"reference {ref_ms:.3f} ms (CUDA events, 2 calls each after one) ({gpu})")
    check(same, "distributed: pipeline: pipeline_apply differs from reference_apply")
    check(got_n == want and ref_n == want,
          f"distributed: pipeline: launches {got_n} and {ref_n}, expected {want}")
    check(bool(torch.isfinite(logits).all()), "distributed: pipeline: non-finite logits")
    del params, bundle, stages, x, got, ref, counts
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=got_n, ref_launches=ref_n, pipeline_ms=pipe_ms, reference_ms=ref_ms)


def dist_elastic(gpu):
    """OLMo-1B's params and AdamW state after one ``bundle.train_step`` at 1 x
    2048, saved (placed under ``ELASTIC_SAVE_MESH``), then the params
    restored by ``restore_elastic`` under each of ``ELASTIC_RESTORES``: every
    leaf back bit for bit, a target of a wrong shape rejected. Reports save
    and restore ms and each placement's bytes a rank of params and moments
    (the moments' by ``opt_specs``)."""
    import gc
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import save
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import synthetic_batches
    from repro_torch.distributed.elastic import restore_elastic
    from repro_torch.core import tree
    from repro_torch.distributed.sharding import opt_specs, param_specs, rank_bytes, to_named
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import checkpoint_tree
    from repro_torch.models import build_model

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("olmo-1b").with_overrides(attn_impl="flash")
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    opt = bundle.init_opt(params)
    hb = next(synthetic_batches(cfg.vocab_size, 1, 2048, 0))
    params, opt, loss = bundle.train_step(
        params, opt, {k: torch.as_tensor(v, device="cuda") for k, v in hb.items()})
    check(bool(torch.isfinite(loss)), f"distributed: elastic: step loss {float(loss)}")
    state = checkpoint_tree(params, opt, leaf=lambda t: t.detach())
    target = tree.map(lambda t: t.to("meta"), state)
    nbytes = sum(t.numel() * t.element_size() for t in tree.leaves(state))

    def placed_bytes(c, mesh):
        psp = param_specs(target["params"], c, mesh)
        osp = opt_specs(target["opt"], psp, c, mesh)
        return {"params": rank_bytes(to_named(psp, mesh, target["params"])),
                "m": rank_bytes(to_named(osp["m"], mesh, target["opt"]["m"])),
                "v": rank_bytes(to_named(osp["v"], mesh, target["opt"]["v"]))}

    root = tempfile.mkdtemp(prefix="elastic-")
    out = {"bytes": nbytes, "restores": []}
    try:
        save_mesh = make_local_mesh(*ELASTIC_SAVE_MESH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(root, 1, state)
        out["save_ms"] = (time.perf_counter() - t0) * 1e3
        out["saved_rank_bytes"] = placed_bytes(cfg, save_mesh)
        log(f"distributed: elastic: {cfg.name} params and AdamW state after one step (loss "
            f"{float(loss):.4f}), {nbytes} B, saved in {out['save_ms']:.1f} ms; under "
            f"{save_mesh} with {cfg.sharding_preset} a rank holds {out['saved_rank_bytes']} "
            f"B ({gpu})")
        for shape, preset in ELASTIC_RESTORES:
            c = cfg.with_overrides(sharding_preset=preset)
            mesh = make_local_mesh(*shape)
            t0 = time.perf_counter()
            got = restore_elastic(root, 1, c, mesh, {"params": target["params"]})
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
                tree.leaves(got["params"]), tree.leaves(state["params"]), strict=True))
            held = placed_bytes(c, mesh)
            check(rank_bytes(got.placement["params"]) == held["params"],
                  "distributed: elastic: placement bytes")
            log(f"distributed: elastic: restored the params under {mesh} with {preset} in "
                f"{ms:.1f} ms, bit for bit {same}; a rank holds {held} B of the {nbytes} "
                f"(the moments' by opt_specs) ({gpu})")
            check(same, f"distributed: elastic: the restore under {shape} differs")
            out["restores"].append(dict(mesh=list(shape), preset=preset, ms=ms,
                                        rank_bytes=held))
            del got
        bad = {"params": tree.map(lambda t: t[..., :max(1, t.shape[-1] // 2)],
                                  target["params"])}
        try:
            restore_elastic(root, 1, cfg, save_mesh, bad)
            check(False, "distributed: elastic: a target of the wrong shape was restored")
        except ValueError as e:
            log(f"distributed: elastic: a target of the wrong shape rejected: {e}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del params, opt, bundle, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def distributed_phase():
    """Phase 9: ``dist_ep``, ``dist_pipeline`` and ``dist_elastic``, each
    timed by its own log line."""
    gpu = card()
    out, t_all = {}, time.perf_counter()
    for label, run in (("ep", dist_ep), ("pipeline", dist_pipeline),
                       ("elastic", dist_elastic)):
        t0 = time.perf_counter()
        out[label] = run(gpu)
        log(f"distributed: {label} took {time.perf_counter() - t0:.1f} s ({gpu})")
    log(f"distributed: phase took {time.perf_counter() - t_all:.1f} s ({gpu})")
    return out


# ---------------------------------------------------------------------------
# phase 9: launch — the dry run and ignis-submit
# ---------------------------------------------------------------------------

#: worker processes that price the sweep's pieces at once (the machine's
#: CPU cores); fake tensors only, no device work
LAUNCH_WORKERS = 8
#: the archs whose cells also run on the two-pod mesh: one of each family
#: (the single-pod sweep takes more than 30 s on the card: PERF.md §4)
LAUNCH_MULTI_POD = ("qwen3-14b", "mixtral-8x7b", "mamba2-780m", "jamba-1.5-large-398b",
                    "internvl2-1b", "whisper-tiny")
#: OLMo-1B's two cells one card runs, B x S (TRAIN_RUNS' shape), and the
#: timed calls of each real run
LAUNCH_OLMO = (4, 2048)
LAUNCH_REPS = 3
#: the phase's time budget, seconds (logged against its wall time)
LAUNCH_BUDGET_S = 60
#: ignis-submit's attached driver: the hybrid wordcount at 2^20 words
SUBMIT_LOG2N = 20
SUBMIT_VOCAB = 1 << 16
#: how long the detached driver's log line is polled for, seconds
SUBMIT_POLL_S = 30
#: the JAX dry run's record keys (its ``xla_cost`` is the port's ``graph_cost``)
JAX_RECORD_KEYS = ("key", "arch", "shape", "mesh", "chips", "kind", "tag", "overrides",
                   "ok", "lower_s", "compile_s", "memory", "graph_cost", "parsed",
                   "top_collectives", "roofline", "total_s")
JAX_MEMORY_KEYS = ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
                   "alias_size_in_bytes", "generated_code_size_in_bytes", "per_device_total")
JAX_ROOFLINE_KEYS = ("compute_s", "memory_s", "collective_s", "dominant", "model_flops",
                     "useful_ratio", "step_time_s", "roofline_fraction")
JAX_PARSED_KEYS = ("flops_per_device", "hbm_bytes_per_device", "comm_bytes_per_device",
                   "comm_bytes_total_per_device", "wire_bytes_per_device",
                   "unknown_trip_loops", "n_computations")

WORDCOUNT_DRIVER = '''"""ignis-submit's attached driver in chip_smoke.py's launch phase: the
hybrid wordcount (a dataflow reduceByKey and the native SPMD app) on the
card, with the properties ignis-submit passed in its environment."""
import argparse
import json
import os
import sys
import time

T0 = time.perf_counter()
sys.path.insert(0, {src!r})

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import kernels as K  # noqa: E402
from repro_torch.core import ICluster, IProperties, IWorker  # noqa: E402
from repro_torch.core.native import ignis_export  # noqa: E402


@ignis_export("wordcount")
def wordcount(ctx, data=None, valid=None):
    vocab = int(ctx.var("vocab"))
    ids = torch.where(valid, data["word"], vocab).long()
    counts = torch.bincount(ids, minlength=vocab + 1)[:-1].to(torch.int32)
    keys = torch.arange(vocab, dtype=torch.int32, device=ids.device)
    return {{"key": keys, "value": counts}}, counts > 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--log2n", type=int, default=20)
    ap.add_argument("--vocab", type=int, default=1 << 16)
    a = ap.parse_args()
    t_import = time.perf_counter() - T0
    env = {{k: v for k, v in os.environ.items() if k.startswith("IGNIS_")}}
    n = 1 << a.log2n
    words = (np.random.default_rng(0).zipf(1.1, n) % a.vocab).astype(np.int32)
    w = IWorker(ICluster(IProperties({{
        "ignis.device": env["IGNIS_IGNIS_DEVICE"],
        "ignis.executor.instances": env["IGNIS_IGNIS_EXECUTOR_INSTANCES"]}})), "python")
    t_worker = time.perf_counter() - T0
    K.reset_launches()
    src = w.parallelize({{"word": words}})
    counts = (src.map(lambda r: {{"key": r["word"], "value": 1}})
              .reduce_by_key(lambda x, y: x + y, 0))
    native = w.call("wordcount", src, vocab=a.vocab)
    exp = np.bincount(words, minlength=a.vocab)
    want = {{k: int(v) for k, v in enumerate(exp) if v}}
    got = {{int(r["key"]): int(r["value"]) for r in counts.collect()}}
    got_native = {{int(r["key"]): int(r["value"]) for r in native.collect()}}
    ok = got == want and got_native == want
    launches = {{k: fn.launches for k, fn in K.launch_counters().items()}}
    report = dict(env=env, words=n, distinct=len(got), ok=ok, launches=launches,
                  device_peak_bytes=torch.cuda.max_memory_allocated(), import_s=t_import,
                  worker_s=t_worker, total_s=time.perf_counter() - T0)
    with open(a.out, "w") as f:
        json.dump(report, f)
    print(f"wordcount driver: {{n}} words, {{len(got)}} distinct, the dataflow's and the "
          f"native app's counts {{'equal' if ok else 'DIFFER from'}} np.bincount; launches "
          f"{{launches}}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
'''

LOG_DRIVER = '''"""ignis-submit's detached driver in chip_smoke.py's launch phase: one
line to its log."""
import os

print(f"detached driver ran as job {{os.environ['IGNIS_JOB_NAME']}}", flush=True)
'''


def _record_arguments(cfg, cell, mesh):
    """The bytes a rank holds of the cell's step arguments, summed over
    the placements of the sharding rules' specs (as the JAX dry run's
    ``in_shardings``)."""
    from repro_torch.core import tree
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import dryrun

    _bundle, args, (ptree, otree) = dryrun.abstract_cell(cfg, cell, "cuda")
    psp = S.param_specs(ptree, cfg, mesh)
    trees = [S.to_named(psp, mesh, ptree)]
    if cell.kind == "train":
        trees += [S.to_named(S.opt_specs(otree, psp, cfg, mesh), mesh, otree),
                  S.to_named(S.input_specs_sharding(args[2], cfg, mesh), mesh, args[2])]
    elif cell.kind == "prefill":
        trees.append(S.to_named(S.input_specs_sharding(args[1], cfg, mesh), mesh, args[1]))
    else:
        trees += [S.to_named(S.cache_specs(args[1], cfg, mesh), mesh, args[1]),
                  S.to_named(S.input_specs_sharding({"tokens": args[2]}, cfg, mesh)["tokens"],
                             mesh, args[2])]
    return sum(p.rank_bytes for t in trees for p in tree.leaves(t))


def check_dry_record(rec, cfg, cell, mesh):
    """A dry-run record: ok, JAX's keys, the mesh's rank count, the model
    FLOPs exactly ``(6 | 2) x active params x tokens``, the argument bytes
    exactly the placements' sum, every memory and time term finite and
    non-negative."""
    import math

    what = f"launch: dryrun {rec.get('key')}"
    check(rec.get("ok") is True, f"{what}: not ok: {rec.get('error')}")
    for keys, got, part in ((JAX_RECORD_KEYS, rec, "record"),
                            (JAX_MEMORY_KEYS, rec["memory"], "memory"),
                            (JAX_ROOFLINE_KEYS, rec["roofline"], "roofline"),
                            (JAX_PARSED_KEYS, rec["parsed"], "parsed")):
        missing = set(keys) - set(got)
        check(not missing, f"{what}: the {part} lacks the JAX record's keys {sorted(missing)}")
    check(rec["chips"] == mesh.size, f"{what}: chips {rec['chips']}, the mesh has {mesh.size}")
    tokens = cell.global_batch * (1 if cell.kind == "decode" else cell.seq_len)
    want = (6 if cell.kind == "train" else 2) * cfg.active_param_count() * tokens
    check(rec["roofline"]["model_flops"] == want,
          f"{what}: model_flops {rec['roofline']['model_flops']}, the formula gives {want}")
    args = _record_arguments(cfg, cell, mesh)
    check(rec["memory"]["argument_size_in_bytes"] == args,
          f"{what}: argument bytes {rec['memory']['argument_size_in_bytes']}, the "
          f"placements hold {args}")
    terms = [*(rec["memory"][k] for k in JAX_MEMORY_KEYS),
             *(rec["roofline"][k] for k in ("compute_s", "memory_s", "collective_s",
                                            "step_time_s"))]
    check(all(math.isfinite(v) and v >= 0 for v in terms),
          f"{what}: a memory or time term is negative or not finite: {terms}")


def launch_sweep(gpu, olmo_cells):
    """Every ``ASSIGNED`` arch x its ``shape_cells()`` on the production
    mesh (and ``LAUNCH_MULTI_POD``'s on the two-pod one), fake CUDA tensors
    priced in ``LAUNCH_WORKERS`` processes (OLMo-1B's two card cells with
    them), each record checked (``check_dry_record``) and appended to a
    JSONL that must read back equal."""
    import torch

    from repro_torch.configs import ASSIGNED, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    t0 = time.perf_counter()
    cells = [(a, {}, c) for a in ASSIGNED for c in get_config(a).shape_cells()]
    pieces = dryrun.prefetch(cells + olmo_cells, LAUNCH_WORKERS, device="cuda")
    t_pieces = time.perf_counter() - t0
    log(f"launch: dryrun: {pieces['pieces']} pieces priced in {t_pieces:.1f} s by "
        f"{LAUNCH_WORKERS} workers ({os.cpu_count()} CPUs, "
        f"{len(os.sched_getaffinity(0))} usable), {pieces['busy_s']:.1f} s of their time in "
        f"all (a worker's start {pieces['warm_s']:.1f} s); the dearest piece "
        f"{pieces['dearest'][1]}: {pieces['dearest'][0]:.1f} s")
    path = os.path.join(HERE, "build", "dryrun", "smoke.jsonl")
    if os.path.exists(path):
        os.remove(path)
    recs = []
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi, device="cuda")
        for arch, _, cell in cells:
            if multi and LAUNCH_MULTI_POD is not None and arch not in LAUNCH_MULTI_POD:
                continue
            rec = dryrun.run_cell(arch, cell.name, multi, verbose=False, device="cuda")
            check_dry_record(rec, get_config(arch), cell, mesh)
            dryrun.append_record(path, rec)
            recs.append(rec)
    took = time.perf_counter() - t0
    back = dryrun.load_done(path)
    check(len(back) == len(recs) and all(back[r["key"]] == json.loads(json.dumps(r))
                                         for r in recs),
          f"launch: dryrun: {path} does not read back the {len(recs)} records written")
    cap = torch.cuda.get_device_properties(0).total_memory
    for r in recs:
        rf = r["roofline"]
        log(f"launch: dryrun {r['key']}: per_device_total "
            f"{r['memory']['per_device_total'] / 2**30:.2f} GiB, {rf['dominant']} dominant, "
            f"step_time_s {rf['step_time_s']:.6g} (compute {rf['compute_s']:.4g}, memory "
            f"{rf['memory_s']:.4g}, collective {rf['collective_s']:.4g}), useful_ratio "
            f"{rf['useful_ratio']:.3f}, kernel calls {r['kernel_calls']}")
    over = [r["key"] for r in recs if r["memory"]["per_device_total"] > cap]
    log(f"launch: dryrun: {len(recs)} cells ({len(cells)} single-pod, {len(recs) - len(cells)} "
        f"two-pod) in {took:.1f} s ({pieces['pieces']} pieces priced by {LAUNCH_WORKERS} "
        f"workers in {t_pieces:.1f} s), every record ok with JAX's keys and read back from {path}; "
        f"{len(over)} cells need more than the card's {cap / 2**30:.1f} GiB a rank: {over} "
        f"(rates of the H100 SXM data sheet; {gpu})")
    return dict(cells=len(recs), seconds=took, prefetch_s=t_pieces, over_card=over)


def _olmo_cells():
    from repro_torch.configs import ShapeCell

    B, S = LAUNCH_OLMO
    return {kind: ShapeCell(f"olmo_{kind}_card", S, B, kind) for kind in ("prefill", "train")}


def launch_olmo(gpu):
    """OLMo-1B (flash) on ``make_local_mesh(1, 1)``: each of the two card
    cells priced by ``run_cell(cell=)``, then run for real through
    ``step_for_cell``'s ``fn`` with random bf16 weights. Held: the argument
    bytes equal the real arguments' ``nbytes``; the flash calls of a
    priced prefill layer times the layers equal the real prefill's flash
    launches. Reported: the predicted peak and step time against the
    card's, the roofline at ``calibrate()``'s rates, the train step's priced
    kernel calls against its launches."""
    import gc

    import torch

    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model
    from repro_torch.profile import calibrate

    over = {"attn_impl": "flash"}
    cfg = get_config("olmo-1b").with_overrides(**over)
    mesh = make_local_mesh(1, 1, device="cuda")
    rates = calibrate(n=8192, repeats=5)
    bundle = build_model(cfg)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = bundle.init(g)
    B, S = LAUNCH_OLMO
    out = {}
    for kind, cell in _olmo_cells().items():
        rec = dryrun.run_cell("olmo-1b", cell.name, False, verbose=False, overrides=over,
                              tag="card", device="cuda", mesh=mesh, cell=cell)
        check_dry_record(rec, cfg, cell, mesh)
        fn, _fake = bundle.step_for_cell(cell)
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device="cuda",
                               dtype=torch.int32)
        if kind == "train":
            opt = bundle.init_opt(params)
            labels = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device="cuda",
                                   dtype=torch.int32)
            args = (params, opt, {"tokens": tokens, "labels": labels})
        else:
            args = (params, {"tokens": tokens})
        real = sum(t.nbytes for t in params.parameters()) + sum(
            t.nbytes for a in args[1:] for t in tree.leaves(a))
        check(rec["memory"]["argument_size_in_bytes"] == real,
              f"launch: olmo {kind}: predicted argument bytes "
              f"{rec['memory']['argument_size_in_bytes']}, the real arguments hold {real}")
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        fn(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = {k: f.launches for k, f in K.launch_counters().items() if f.launches}
        ms = time_ms(lambda: fn(*args), LAUNCH_REPS)
        per_layer = rec["kernel_calls_per_layer"]
        check(len(per_layer) == 1, f"launch: olmo {kind}: signatures {per_layer}")
        layer_flash = next(iter(per_layer.values())).get("flash_attention", 0)
        if kind == "prefill":
            check(layer_flash * cfg.num_layers == launches.get("flash_attention", 0)
                  == rec["kernel_calls"].get("flash_attention"),
                  f"launch: olmo prefill: {layer_flash} flash calls priced a layer x "
                  f"{cfg.num_layers} layers against {launches} real launches (the record's "
                  f"{rec['kernel_calls']})")
        rf, pa = rec["roofline"], rec["parsed"]
        cal = {"compute_s": pa["flops_per_device"] / rates.flops_per_s,
               "memory_s": pa["hbm_bytes_per_device"] / rates.hbm_bytes_per_s}
        cal["step_time_s"] = max(cal.values())
        out[kind] = dict(predicted_total=rec["memory"]["per_device_total"], peak=peak,
                         step_time_s=rf["step_time_s"], ms=ms, calibrated=cal,
                         priced_calls=rec["kernel_calls"], launches=launches,
                         layer_flash=layer_flash, memory=rec["memory"])
        log(f"launch: olmo {kind} {B} x {S} on make_local_mesh(1, 1): argument bytes "
            f"{real} predicted exactly; per_device_total predicted "
            f"{rec['memory']['per_device_total'] / 2**30:.2f} GiB (arguments "
            f"{rec['memory']['argument_size_in_bytes'] / 2**30:.2f}, outputs "
            f"{rec['memory']['output_size_in_bytes'] / 2**30:.2f}, temp "
            f"{rec['memory']['temp_size_in_bytes'] / 2**30:.2f}, aliased "
            f"{rec['memory']['alias_size_in_bytes'] / 2**30:.2f}) against "
            f"max_memory_allocated {peak / 2**30:.2f} GiB; step_time_s predicted "
            f"{rf['step_time_s'] * 1e3:.2f} ms ({rf['dominant']}: compute "
            f"{rf['compute_s'] * 1e3:.2f} ms, memory {rf['memory_s'] * 1e3:.2f} ms at the data "
            f"sheet's 989 TFLOP/s and 3.35 TB/s) against {ms:.2f} ms measured (CUDA events, "
            f"{LAUNCH_REPS} calls); at calibrate()'s {rates.flops_per_s / 1e12:.1f} TFLOP/s "
            f"(f32 matmul) and {rates.hbm_bytes_per_s / 1e12:.2f} TB/s: compute "
            f"{cal['compute_s'] * 1e3:.2f} ms, memory {cal['memory_s'] * 1e3:.2f} ms; "
            f"kernel calls priced {rec['kernel_calls']} ({layer_flash} flash a layer) against "
            f"launches {launches} (not held in train) ({gpu})")
        del args, fn
    del params, bundle
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _submit_dirs():
    root = os.path.join(HERE, "build", "launch")
    return root, os.path.join(root, "jobs")


def launch_submit_attached(gpu):
    """``ignis-submit --attach`` of the hybrid wordcount driver on the card:
    rc 0, ``job.json``'s fields, the ``IGNIS_*`` variables the driver saw,
    its counts against ``np.bincount``."""
    import shutil

    from repro_torch.launch import submit

    root, jobs = _submit_dirs()
    shutil.rmtree(jobs, ignore_errors=True)
    os.makedirs(jobs)
    driver = os.path.join(root, "wordcount_driver.py")
    with open(driver, "w") as f:
        f.write(WORDCOUNT_DRIVER.format(src=os.path.join(HERE, "src")))
    report = os.path.join(root, "wordcount_report.json")
    if os.path.exists(report):
        os.remove(report)
    props = {"ignis.device": "cuda", "ignis.executor.instances": "8"}
    dargs = ["--out", report, "--log2n", str(SUBMIT_LOG2N), "--vocab", str(SUBMIT_VOCAB)]
    argv = ["--name", "smoke-attached", "--jobs-dir", jobs, "--attach"]
    for k, v in props.items():
        argv += ["--properties", f"{k}={v}"]
    t0 = time.perf_counter()
    rc = submit.main([*argv, "ignishpc/torch", driver, *dargs])
    took = time.perf_counter() - t0
    check(rc == 0, f"launch: submit: the attached driver returned {rc}")
    with open(os.path.join(jobs, "smoke-attached", "job.json")) as f:
        spec = json.load(f)
    want = {"name": "smoke-attached", "image": "ignishpc/torch", "driver": driver,
            "args": dargs, "properties": props}
    check(spec == want, f"launch: submit: job.json {spec}, expected {want}")
    with open(report) as f:
        rep = json.load(f)
    env = {k: v for k, v in os.environ.items() if k.startswith("IGNIS_")}
    env.update({"IGNIS_IGNIS_DEVICE": "cuda", "IGNIS_IGNIS_EXECUTOR_INSTANCES": "8",
                "IGNIS_JOB_NAME": "smoke-attached"})
    check(rep["env"] == env, f"launch: submit: the driver saw {rep['env']}, expected {env}")
    check(rep["ok"] and rep["words"] == 1 << SUBMIT_LOG2N and rep["device_peak_bytes"] > 0,
          f"launch: submit: the driver's report {rep}")
    log(f"launch: submit --attach: the wordcount driver ({rep['words']} words, "
        f"{rep['distinct']} distinct, counts equal np.bincount, launches {rep['launches']}, "
        f"device peak {rep['device_peak_bytes'] / 2**20:.1f} MiB; in the driver: imports "
        f"{rep['import_s']:.1f} s, the worker up at {rep['worker_s']:.1f} s, done at "
        f"{rep['total_s']:.1f} s) returned 0 in {took:.1f} s; "
        f"job.json and the IGNIS_* environment as given ({gpu})")
    return dict(attached_s=took, driver=rep)


def launch_submit_detached(gpu):
    """``ignis-submit`` detached: it returns at once; the driver's log line
    is polled for at most ``SUBMIT_POLL_S`` and its process waited for."""
    import contextlib
    import io

    from repro_torch.launch import submit

    root, jobs = _submit_dirs()
    ldriver = os.path.join(root, "log_driver.py")
    with open(ldriver, "w") as f:
        f.write(LOG_DRIVER.format())
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = submit.main(["--name", "smoke-detached", "--jobs-dir", jobs, "ignishpc/torch",
                          ldriver])
    check(rc == 0, f"launch: submit: a detached launch returned {rc}")
    pid = int(buf.getvalue().split("(pid ")[1].split(",")[0])
    logfile = os.path.join(jobs, "smoke-detached", "driver.log")
    line, status = "", None
    while time.perf_counter() - t0 < SUBMIT_POLL_S:
        with open(logfile) as f:
            line = f.read()
        if status is None:
            try:
                done, status = os.waitpid(pid, os.WNOHANG)
                status = status if done else None
            except ChildProcessError:  # reaped by subprocess' own clean-up: it has exited
                status = 0
        if "detached driver ran as job smoke-detached" in line and status is not None:
            break
        time.sleep(0.05)
    if status is None:
        os.kill(pid, 9)
        os.waitpid(pid, 0)
    check("detached driver ran as job smoke-detached" in line,
          f"launch: submit: the detached driver's log holds {line!r} after {SUBMIT_POLL_S} s")
    check(status == 0, f"launch: submit: the detached driver exited with status {status}")
    took = time.perf_counter() - t0
    log(f"launch: submit (detached): returned at once, the driver's log line came and the "
        f"driver exited 0 within {took:.2f} s ({gpu})")
    return dict(detached_s=took)


def launch_phase():
    """Phase 10: the dry run's sweep (``launch_sweep``, its pricing on the
    CPU's cores) while ``ignis-submit --attach`` runs its driver on the card
    (``launch_submit_attached``, a thread waiting on the driver's process),
    then OLMo-1B's two card cells priced and run (``launch_olmo``) and a
    detached submit (``launch_submit_detached``); the wall time logged
    against ``LAUNCH_BUDGET_S``."""
    gpu = card()
    t0 = time.perf_counter()
    olmo = _olmo_cells()
    attached = {}

    def submit_attached():
        try:
            attached["out"] = launch_submit_attached(gpu)
        except BaseException as e:  # raised again below, on the phase's thread
            attached["error"] = e

    thread = threading.Thread(target=submit_attached, name="submit-attached")
    thread.start()
    try:
        out = {"sweep": launch_sweep(gpu, [("olmo-1b", {"attn_impl": "flash"}, c)
                                           for c in olmo.values()])}
    finally:
        thread.join()
    if "error" in attached:
        raise attached["error"]
    out["olmo"] = launch_olmo(gpu)
    out["submit"] = {**attached["out"], **launch_submit_detached(gpu)}
    took = time.perf_counter() - t0
    out["seconds"] = took
    log(f"launch: phase took {took:.1f} s ({'within' if took <= LAUNCH_BUDGET_S else 'OVER'} "
        f"its {LAUNCH_BUDGET_S} s budget; sweep {out['sweep']['seconds']:.1f} s) ({gpu})")
    return out


def flash_row(launches, reps: int):
    """The flash kernel at the serve path's largest prefill shape, timed
    beside its bound, its plain version and torch's fused SDPA."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import attention_ref

    cnt, _t, geoms = launches["flash_attention"]
    qs, ks, dts, causal, window, cap, off = max(geoms, key=lambda gm: gm[0][2])
    dt = getattr(torch, dts.split(".")[1])
    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn(qs, generator=g, device="cuda").to(dt)
    k = torch.randn(ks, generator=g, device="cuda").to(dt)
    v = torch.randn(ks, generator=g, device="cuda").to(dt)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=off)
    got, ref = flash_attention_fwd(q, k, v, **kw), attention_ref(q, k, v, **kw)
    atol, rtol = FLASH_TOL[dts]
    rel = rel_l2(got, ref)
    check(torch.allclose(got.float(), ref.float(), atol=atol, rtol=rtol)
          and (dt != torch.bfloat16 or rel <= FLASH_BF16_REL_L2),
          f"flash at {qs}: max abs err {max_err(got, ref)}, relative L2 {rel}")
    check(window is None and cap == 0.0 and off == 0 and causal,
          "the serve path's flash call is plain causal: the library call below "
          "computes the same function only then")
    flop = flash_flop(qs, ks, causal, off)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_ops = flop / (BF16_FLOP_PER_S if dt == torch.bfloat16 else F32_FLOP_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    row = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:76",
        launches=cnt, max_abs_err=max_err(got, ref),
        ms=time_ms(lambda: flash_attention_fwd(q, k, v, **kw), reps),
        plain_ms=time_ms(lambda: attention_ref(q, k, v, **kw), max(reps // 4, 2)),
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), reps),
        device_ms=device_ms(lambda: flash_attention_fwd(q, k, v, **kw)),
        shape=[list(qs), list(ks)], dtype=dts, flop=flop)
    log(f"kernel flash_attention: q {qs} k/v {ks} {dts} causal launches {cnt} max_abs_err "
        f"{row['max_abs_err']}, relative L2 {rel:.3e} (tolerance {FLASH_BF16_REL_L2} in bf16) "
        f"| {row['ms']:.4f} ms (earlier design {RECORDED_EARLIER_MS['flash_attention']} ms as "
        f"recorded, not measured here; "
        f"f32 FMA floor {flop / F32_FLOP_PER_S * 1e3:.4f} ms) vs bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}: {flop:.3e} FLOP / 989 TFLOP/s, {nbytes} B / 3.35 TB/s) | "
        f"plain {row['plain_ms']:.4f} ms | library (SDPA) {row['library_ms']:.4f} ms | device "
        f"{row['device_ms']} ms (torch.profiler)")
    # the longest prompt the serve path admits (2048 tokens), whatever the seed drew
    q2 = torch.randn((1, qs[1], 2048, qs[3]), generator=g, device="cuda").to(dt)
    k2 = torch.randn((1, ks[1], 2048, ks[3]), generator=g, device="cuda").to(dt)
    ms2 = time_ms(lambda: flash_attention_fwd(q2, k2, k2, causal=True), reps)
    bound2 = flash_flop(q2.shape, k2.shape, True, 0) / BF16_FLOP_PER_S * 1e3
    log(f"kernel flash_attention: at q {tuple(q2.shape)} (the longest admitted prompt) "
        f"{ms2:.4f} ms vs bound {bound2:.4f} ms (operations) | plain "
        f"{time_ms(lambda: attention_ref(q2, k2, k2), max(reps // 4, 2)):.4f} ms | SDPA "
        f"{time_ms(lambda: F.scaled_dot_product_attention(q2, k2, k2, is_causal=True, enable_gqa=True), reps):.4f} ms")
    return row


def decode_lengths(seed):
    """The serve cell's positions at one decode tick: 128 slots, each a
    request of the mix (``DECODE_MIX``) drawn with weight its output length
    (the ticks it holds a slot), part way through its output."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def law(median, sigma, lo, hi, n):
        return np.clip(np.round(median * np.exp(sigma * rng.standard_normal(n))), lo, hi)

    pool = 1 << 16
    prompts, outs = law(*DECODE_MIX["prompt"], pool), law(*DECODE_MIX["output"], pool)
    pick = rng.choice(pool, DECODE_CELL["slots"], p=outs / outs.sum())
    done = np.floor(rng.random(DECODE_CELL["slots"]) * outs[pick])
    return (prompts[pick] + done).astype(np.int32)


def decode_row(launches, reps: int):
    """The decode kernel at the serve cell's shape (``DECODE_CELL``, the
    positions of ``decode_lengths``), timed beside its bound (the live K and
    V rows, q and o once at 3.35 TB/s) and the plain version; and at the 4
    slots of this script's Qwen3-14B serve phase (the split route)."""
    import numpy as np
    import torch

    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention_fwd, splits, variant)
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    c = DECODE_CELL
    B, Smax, K, G, hd = c["slots"], c["cache_len"], c["kv_heads"], c["group"], c["head_dim"]
    lens = decode_lengths(7)
    g = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn((B, 1, K * G, hd), generator=g, device="cuda").to(torch.bfloat16)
    k = torch.randn((B, Smax, K, hd), generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn((B, Smax, K, hd), generator=g, device="cuda").to(torch.bfloat16)
    pos = torch.as_tensor(lens, device="cuda")
    got, ref = decode_attention_fwd(q, k, v, pos), decode_attention_ref(q, k, v, pos)
    rel = rel_l2(got, ref)
    check(torch.allclose(got.float(), ref.float(), atol=DECODE_TOL[0], rtol=DECODE_TOL[1])
          and rel <= DECODE_REL_L2, f"decode at the serve cell: max abs err "
          f"{max_err(got, ref)}, relative L2 {rel}")
    live = int(np.minimum(lens + 1, Smax).sum())
    nbytes = 2 * live * K * hd * 2 + 2 * q.numel() * 2
    cnt, _t, _g = launches["decode_attention"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    row = dict(
        name="decode_attention", route=variant(splits(B, K, Smax, sms)),
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces="none (the JAX package's decode is the plain masked attention)",
        launches=cnt, max_abs_err=max_err(got, ref),
        ms=time_ms(lambda: decode_attention_fwd(q, k, v, pos), reps),
        plain_ms=time_ms(lambda: decode_attention_ref(q, k, v, pos), max(reps // 4, 2)),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        device_ms=device_ms(lambda: decode_attention_fwd(q, k, v, pos)),
        shape=[list(q.shape), list(k.shape)], dtype="torch.bfloat16", live_rows=live,
        bytes=nbytes)
    log(f"kernel decode_attention: q {tuple(q.shape)} k/v {tuple(k.shape)} bf16, {live} live "
        f"rows of {B * Smax} (mean {live / B:.0f} a slot, positions from the serve mix) "
        f"launches {cnt} max_abs_err {row['max_abs_err']}, relative L2 {rel:.3e} "
        f"(tolerance {DECODE_REL_L2}) | {row['ms']:.4f} ms ({nbytes / row['ms'] / 1e6:.0f} "
        f"GB/s) vs bound {row['bound_ms']:.4f} ms (bytes: {nbytes} B / 3.35 TB/s) | plain "
        f"{row['plain_ms']:.4f} ms | device {row['device_ms']} ms (torch.profiler); route "
        f"{row['route']}")
    del q, k, v, got, ref
    # the serve phases' shape: Qwen3-14B's 4 slots of 4096, 8 kv heads, G = 5
    B, Smax, K, G = SERVE_SLOTS, SERVE_CACHE_LEN, 8, 5
    q = torch.randn((B, 1, K * G, hd), generator=g, device="cuda").to(torch.bfloat16)
    k = torch.randn((B, Smax, K, hd), generator=g, device="cuda").to(torch.bfloat16)
    pos = torch.tensor([600, 1800, 2500, 4000], dtype=torch.int32, device="cuda")
    live = int(np.minimum(pos.cpu().numpy() + 1, Smax).sum())
    nbytes = 2 * live * K * hd * 2 + 2 * q.numel() * 2
    n = splits(B, K, Smax, sms)
    ms = time_ms(lambda: decode_attention_fwd(q, k, k, pos), reps)
    log(f"kernel decode_attention: at Qwen3-14B's serve phase q {tuple(q.shape)} k/v "
        f"{tuple(k.shape)}, pos {pos.tolist()}, {n} splits ({variant(n)}): {ms:.4f} ms vs "
        f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms | plain "
        f"{time_ms(lambda: decode_attention_ref(q, k, k, pos), max(reps // 4, 2)):.4f} ms")
    return row


#: one library each; ``segment_reduce`` holds the segmented scan and the prefix scan
CUDA_SOURCES = ("flash_attention", "ssd_scan", "moe_route", "segment_reduce", "bucket_route",
                "decode_attention")


def _demangled(names, bin_dir):
    """``names`` demangled by the toolkit's ``cu++filt`` (or ``c++filt``),
    as they are where neither is found."""
    import shutil

    for tool in (os.path.join(bin_dir, "cu++filt"), shutil.which("cu++filt"),
                 shutil.which("c++filt")):
        if tool and os.path.exists(tool):
            r = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                               timeout=60)
            out = r.stdout.splitlines()
            if r.returncode == 0 and len(out) == len(names):
                return [n.replace("(anonymous namespace)::", "") for n in out]
    return names


def tensor_core_counts():
    """Per CUDA library, per kernel: the tensor-core instructions in its
    SASS (``HGMMA``: wgmma; ``HMMA``: mma.sync), from ``cuobjdump -sass``
    where the toolkit has one."""
    import re
    import shutil

    from repro_torch.kernels import _cuda

    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_cuda.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        log("build: no cuobjdump in the toolkit: tensor-core instructions not counted")
        return
    for name in CUDA_SOURCES:
        r = subprocess.run([tool, "-sass", str(_cuda.library_path(name))],
                           capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            log(f"build: cuobjdump -sass {name} failed ({r.returncode}): {r.stderr[-300:]}")
            continue
        fn, counts = None, {}
        for line in r.stdout.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                counts[fn] = {"HGMMA": 0, "HMMA": 0}
            elif fn is not None:
                for op in ("HGMMA", "HMMA"):
                    if re.search(rf"\b{op}\.", line):
                        counts[fn][op] += 1
        names = dict(zip(counts, _demangled(list(counts), os.path.dirname(tool))))
        for fn, c in counts.items():
            log(f"build: sass {name}: {names[fn][:110]}: HGMMA {c['HGMMA']}, HMMA {c['HMMA']}")


def build():
    """Start one ``nvcc`` per CUDA source at once, with the port's flags and
    into the library paths its loader reads (``kernels._cuda``), then run
    the registry's capability probes and launch each kernel once (the loader
    finds the library built), and print what ptxas said (registers, spills)
    of each."""
    import torch

    from repro_torch.kernels import _cuda, registry

    t0 = time.perf_counter()
    procs, logs = {}, {}
    try:
        for name in CUDA_SOURCES:
            out = _cuda.library_path(name)
            if out.exists():
                continue
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_cuda.nvcc(), *_cuda.NVCC_FLAGS, "-o", str(tmp), str(_cuda.CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                            stderr=subprocess.PIPE, text=True), tmp, out)
        for name, (proc, tmp, out) in procs.items():
            logs[name] = proc.communicate()[1]
            if proc.returncode != 0:
                raise SmokeFailure(f"nvcc failed to build {name}.cu (exit {proc.returncode}):"
                                   f"\n{logs[name][-8000:]}")
            os.replace(tmp, out)
    finally:
        for proc, _tmp, _out in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log(f"build: {len(procs)} CUDA libraries "
        f"{[_cuda.library_path(n).name for n in CUDA_SOURCES]} built by parallel nvcc runs "
        f"in {time.perf_counter() - t0:.2f} s (wall)")
    for probe in registry._PROBES.values():  # each reaches its CUDA kernel
        probe("cuda")

    from repro_torch.kernels.decode_attention.decode_attention import decode_attention_fwd
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_fwd
    from repro_torch.kernels.moe_route.moe_route import moe_route_fwd
    from repro_torch.kernels.moe_route.route import bucket_route_fwd
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_reduce_fwd
    from repro_torch.kernels.ssd_scan.prefix import prefix_scan_fwd
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_fwd

    x = torch.zeros((1, 1, 1, 64), device="cuda")
    flash_attention_fwd(x, x, x)  # the fma route
    flash_attention_fwd(x.bfloat16(), x.bfloat16(), x.bfloat16())  # the wgmma route
    for Smax in (128, 256):  # one block a slot, then two splits and the merge
        slab = torch.zeros((1, Smax, 1, 64), dtype=torch.bfloat16, device="cuda")
        decode_attention_fwd(x.bfloat16(), slab, slab,
                             torch.tensor([Smax - 1], dtype=torch.int32, device="cuda"))
    xs = torch.zeros((1, 16, 2, 16), device="cuda")
    bn = torch.zeros((1, 16, 1, 16), device="cuda")
    ssd_scan_fwd(xs, torch.zeros((1, 16, 2), device="cuda"), torch.zeros(2, device="cuda"),
                 bn, bn, 16)
    moe_route_fwd(torch.zeros((3, 4), device="cuda"), 2, 2)
    moe_route_fwd(torch.zeros((300, 4), device="cuda"), 2, 2)  # two tiles: the look-back
    segment_reduce_fwd(torch.zeros((5000, 1), dtype=torch.int32, device="cuda"),
                       torch.ones(5000, dtype=torch.bool, device="cuda"))
    for rev in (False, True):  # two tiles: the look-back
        prefix_scan_fwd(torch.zeros(9000, dtype=torch.int32, device="cuda"), "min", 512, rev)
    bucket_route_fwd(torch.zeros(3, dtype=torch.int32, device="cuda"), 4, 2)
    bucket_route_fwd(torch.zeros(5000, dtype=torch.int32, device="cuda"), 4, 2)  # two tiles
    torch.cuda.synchronize()
    log("build: first launches of " + ", ".join(CUDA_SOURCES) + " (and the prefix scan in "
        "segment_reduce's library): OK")
    for name in CUDA_SOURCES:
        for line in logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"build: ptxas {name}: {line.strip()}")
    tensor_core_counts()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log2n", type=int, default=26, help="log2 of the word count")
    ap.add_argument("--p", type=int, default=8, help="virtual executor ranks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20, help="timed launches per kernel")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401 — fails outside a checkout of the repo

    t_all = time.perf_counter()
    gpu = card()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    # the plain versions' f32 products in full f32, as the kernels compute
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        build()
        launches = main_path(args)
        rows = kernel_checks(launches, args.reps)
        apps_phase()
        recovery_phase()
        launches, _ = serve_qwen(args)
        rows.append(flash_row(launches, args.reps))
        rows.append(decode_row(launches, args.reps))
        launches, _ = serve_mamba(args)
        rows.append(ssd_row(launches, args.reps))
        launches, _ = serve_mixtral(args)
        rows.append(moe_row(launches, args.reps))
        for name, flash in (("olmo-1b", True), ("yi-9b", True), ("gemma3-4b", False)):
            t0 = time.perf_counter()
            serve_dense(args, name, flash)
            log(f"{name}: serve phase took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        serve_phi(args)
        log(f"phi: serve phase took {time.perf_counter() - t0:.1f} s")
        family, t_fam = {}, time.perf_counter()
        for label, phase in FAMILY_PHASES:
            t0 = time.perf_counter()
            family[label] = phase(args)[0]
            log(f"{label}: serve phase took {time.perf_counter() - t0:.1f} s")
        log(f"the family serve phases took {time.perf_counter() - t_fam:.1f} s")
        trained = train_phase()
        dist = distributed_phase()
        launched = launch_phase()
        for row in rows:
            label = TRAIN_KERNEL_RUN.get(row["name"])
            if label:
                row["train_launches"] = trained[label]["launches"][row["name"]]
            if row["name"] in MODEL_KERNELS:
                row["family_launches"] = {
                    **{k: family[k].get(row["name"], 0) for k, _ in FAMILY_PHASES},
                    **{f"train_{k}": trained[k]["launches"].get(row["name"], 0)
                       for k in FAMILY_TRAIN_RUNS}}
            if row["name"] == "moe_route":
                row["ep_launches"] = dist["ep"]["launches"]["moe_route"]
            if row["name"] == "flash_attention":
                olmo = trained["olmo"]
                row["backward"] = {  # the backward kernel at OLMo's layer 0 in training
                    "kernel_ms": olmo["kernel_bwd_ms"], "plain_ms": olmo["bwd_ms"],
                    "train_launches": olmo["launches"]["flash_attention_bwd"],
                    "family_train_launches": {
                        k: trained[k]["launches"]["flash_attention_bwd"]
                        for k in FAMILY_TRAIN_RUNS}}
                row["pipeline_launches"] = dist["pipeline"]["launches"]["flash_attention"]
                row["dryrun_priced_calls"] = (
                    launched["olmo"]["prefill"]["priced_calls"]["flash_attention"])
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(f"gpu: {gpu}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
