"""build_model(cfg): one uniform bundle per architecture family (the port
of ``repro.models.model_zoo``, serving surface, dense family).

Bundle surface (everything the serving engine needs):
  init(generator)                → params (on the generator's device)
  prefill(params, tokens=…, cache_len=None) → (logits, cache)
  decode_step(params, cache, tokens)        → (logits, cache)
  make_cache(batch, max_len, device="cuda") → cache dict (zeros)

Training (``train_loss``/``train_step``), the abstract input specs of the
dry run and the other families come later (ROADMAP A.8).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


@dataclass
class ModelBundle:
    cfg: ArchConfig
    init: Callable
    prefill: Callable
    decode_step: Callable
    make_cache: Callable


def build_model(cfg: ArchConfig) -> ModelBundle:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP A.8: the other "
            f"families of the model zoo)")
    return ModelBundle(
        cfg=cfg,
        init=functools.partial(transformer.make_lm_params, cfg=cfg),
        prefill=lambda params, *, tokens, cache_len=None: transformer.lm_prefill(
            params, tokens, cfg, cache_len=cache_len),
        decode_step=lambda params, cache, tok: transformer.lm_decode_step(
            params, cache, tok, cfg),
        make_cache=lambda batch, max_len, device="cuda": transformer.make_cache(
            cfg, batch, max_len, device=device),
    )
