"""build_model(cfg): one uniform bundle per architecture family (the port
of ``repro.models.model_zoo``: the dense, MoE and SSM families).

Bundle surface (everything the launcher and the serving engine need):
  init(generator)                → params (on the generator's device)
  train_loss(params, batch)      → scalar loss (differentiable)
  train_step(params, opt, batch) → (params, opt, loss); AdamW in place
  init_opt(params)               → the optimizer state ``{m, v, step}``
  prefill(params, tokens=…, cache_len=None) → (logits, cache)
  decode_step(params, cache, tokens)        → (logits, cache)
  make_cache(batch, max_len, device="cuda") → cache dict (zeros)

``build_module(cfg, device)`` makes a family's module with its weights left
uninitialised (``interop.params_from_reference`` fills one). The dry run's
surface — ``input_specs``, ``abstract_params`` and ``step_for_cell`` —
comes with ``launch/dryrun`` (ROADMAP: the rest of ``launch/``); the
hybrid, VLM and audio families come later (ROADMAP: the other families).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import ssm, transformer
from repro_torch.optim.adamw import adamw_update, init_opt_state, named_tensors


@dataclass
class ModelBundle:
    cfg: ArchConfig
    init: Callable
    train_loss: Callable
    prefill: Callable
    decode_step: Callable
    make_cache: Callable

    def value_and_grad(self, params, batch):
        """(loss detached, ``{name: gradient}``) of ``train_loss`` at
        ``batch`` (``jax.value_and_grad``)."""
        named = named_tensors(params)
        loss = self.train_loss(params, batch)
        grads = torch.autograd.grad(loss, list(named.values()))
        return loss.detach(), dict(zip(named, grads))

    def train_step(self, params, opt_state, batch, lr=3e-4):
        A = self.cfg.grad_accum
        if A <= 1:
            loss, grads = self.value_and_grad(params, batch)
            if self.cfg.grad_compress != "none":
                from repro_torch.distributed.compression import compressed_grads

                # the stateless form (the error feedback lives in the real
                # train loop, launch/train.py)
                zeros = {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                         for k, g in grads.items()}
                grads, _ = compressed_grads(grads, zeros, self.cfg.grad_compress)
        else:
            # microbatch accumulation: activation residency ÷ A; the sum is
            # seeded from microbatch 0 and kept in f32, as in the JAX step
            micro = {k: v.reshape(A, v.shape[0] // A, *v.shape[1:]) for k, v in batch.items()}
            loss, g0 = self.value_and_grad(params, {k: v[0] for k, v in micro.items()})
            g_sum = {k: g.float() for k, g in g0.items()}
            del g0
            for i in range(1, A):
                l, g = self.value_and_grad(params, {k: v[i] for k, v in micro.items()})
                g_sum = {k: a + g[k].float() for k, a in g_sum.items()}
                loss = loss + l
                del g
            grads = {k: g / A for k, g in g_sum.items()}
            loss = loss / A
        params, opt_state = adamw_update(grads, opt_state, params, lr=lr)
        return params, opt_state, loss

    def init_opt(self, params):
        return init_opt_state(params, getattr(torch, self.cfg.opt_moment_dtype))


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
            train_loss=functools.partial(transformer.lm_train_loss, cfg=cfg),
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
            train_loss=functools.partial(ssm.ssm_train_loss, cfg=cfg),
            prefill=lambda params, *, tokens, cache_len=None: ssm.ssm_prefill(
                params, tokens, cfg),
            decode_step=lambda params, cache, tok: ssm.ssm_decode_step(
                params, cache, tok, cfg),
            # the recurrent state is O(1): max_len is not used
            make_cache=lambda batch, max_len, device="cuda": ssm.make_ssm_cache(
                cfg, batch, device=device),
        )
    raise _unported(cfg)
