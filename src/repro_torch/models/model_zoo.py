"""build_model(cfg): one uniform bundle per architecture family (the port
of ``repro.models.model_zoo``, serving surface: the dense, MoE and SSM
families).

Bundle surface (everything the serving engine needs):
  init(generator)                → params (on the generator's device)
  prefill(params, tokens=…, cache_len=None) → (logits, cache)
  decode_step(params, cache, tokens)        → (logits, cache)
  make_cache(batch, max_len, device="cuda") → cache dict (zeros)

``build_module(cfg, device)`` makes a family's module with its weights left
uninitialised (``interop.params_from_reference`` fills one). Training
(``train_loss``/``train_step``), the abstract input specs of the dry run and
the hybrid, VLM and audio families come later (ROADMAP: the training
path, the other families).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models import ssm, transformer


@dataclass
class ModelBundle:
    cfg: ArchConfig
    init: Callable
    prefill: Callable
    decode_step: Callable
    make_cache: Callable


def _unported(cfg: ArchConfig):
    return NotImplementedError(
        f"family {cfg.family!r} is not ported yet (ROADMAP: the other families of the "
        f"model zoo)")


def build_module(cfg: ArchConfig, device=None):
    """The family's module on ``device``, weights uninitialised."""
    if cfg.family in ("dense", "moe"):
        return transformer.TransformerLM(cfg, device=device)
    if cfg.family == "ssm":
        return ssm.SSMLM(cfg, device=device)
    raise _unported(cfg)


def build_model(cfg: ArchConfig) -> ModelBundle:
    if cfg.family in ("dense", "moe"):
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
    if cfg.family == "ssm":
        return ModelBundle(
            cfg=cfg,
            init=functools.partial(ssm.make_ssm_params, cfg=cfg),
            prefill=lambda params, *, tokens, cache_len=None: ssm.ssm_prefill(
                params, tokens, cfg),
            decode_step=lambda params, cache, tok: ssm.ssm_decode_step(
                params, cache, tok, cfg),
            # the recurrent state is O(1): max_len is not used
            make_cache=lambda batch, max_len, device="cuda": ssm.make_ssm_cache(
                cfg, batch, device=device),
        )
    raise _unported(cfg)
