"""Serving driver: ``python -m repro_torch.launch.serve --arch <id> --requests N``.

Spins up the continuous-batching engine on a (reduced) model and runs a
synthetic request stream — the minimal "serve a small model with batched
requests" end-to-end path. Runs on the card unless ``--device cpu``.

The engine feeds token prompts, as the JAX one does: every family but the
audio one serves (the VLM text-only); ``--arch whisper-tiny`` raises from
the bundle's prefill, which needs ``frames`` (audio goes through
``bundle.prefill(frames=…, tokens=…)``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="ignis-tiny")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)

    cfg = get_config(a.arch)
    if a.reduced:
        cfg = cfg.reduced()
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device=a.device).manual_seed(0))
    eng = ServeEngine(bundle, params, slots=a.slots, cache_len=a.cache_len)

    rng = np.random.default_rng(0)
    for r in range(a.requests):
        plen = int(rng.integers(4, 16))
        eng.submit(Request(r, rng.integers(0, cfg.vocab_size, plen, dtype=np.int32),
                           max_new_tokens=a.max_new))
    t0 = time.time()
    done = eng.run_to_completion()
    dt = time.time() - t0
    toks = sum(len(r.tokens) for r in done)
    print(f"[serve] {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/max(dt,1e-9):.1f} tok/s)")
    return done


if __name__ == "__main__":
    main()
