"""build_model(cfg): one uniform bundle per architecture family (the port
of ``repro.models.model_zoo``: the dense, MoE, SSM, hybrid, VLM and audio
families).

Bundle surface (everything the launcher and the serving engine need):
  init(generator)                → params (on the generator's device)
  train_loss(params, batch)      → scalar loss (differentiable)
  train_step(params, opt, batch) → (params, opt, loss); AdamW in place
  init_opt(params)               → the optimizer state ``{m, v, step}``
  prefill(params, tokens=…, cache_len=None) → (logits, cache); the VLM
      also takes ``patches=`` (B, P, VIT_DIM), the audio family requires
      ``frames=`` (B, S_enc, D)
  decode_step(params, cache, tokens)        → (logits, cache)
  make_cache(batch, max_len, device="cuda") → cache dict (zeros)

The dry run's abstract surface (``launch/dryrun``), as the JAX bundle's:
  input_specs(cell)   → the cell's inputs as fake tensors
  abstract_params()   → the model with fake weights
  step_for_cell(cell) → (fn, args): the cell's step and its fake arguments
"Abstract" is fake tensors (``torch._subclasses.FakeTensorMode``, one mode
per bundle) on the bundle's ``device``: shapes, dtypes and a device, no
storage, so a 398B model costs no memory; the kernel wrappers price a call
on them (``repro_torch.kernels.fake_call``) and ``profile.cost.trace``
traces them.

``build_module(cfg, device)`` makes a family's module with its weights left
uninitialised (``interop.params_from_reference`` fills one; on the ``meta``
device it only counts, as ``analytic_param_count`` does).
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models import encdec, hybrid, ssm, transformer
from repro_torch.models.transformer import VIT_DIM  # the stub InternViT width
from repro_torch.optim.adamw import adamw_update, init_opt_state, named_tensors
from repro_torch.profile.spans import span

WHISPER_TRAIN_ENC = 1500  # encoder frames for the train cell
WHISPER_PREFILL_DEC = 256  # decoder prompt length for the prefill cell


@dataclass
class ModelBundle:
    cfg: ArchConfig
    init: Callable
    train_loss: Callable
    prefill: Callable
    decode_step: Callable
    make_cache: Callable
    device: str = "cuda"
    max_dec: Optional[int] = None
    _fake: object = field(default=None, repr=False, compare=False)

    def value_and_grad(self, params, batch):
        """(loss detached, ``{name: gradient}``) of ``train_loss`` at
        ``batch`` (``jax.value_and_grad``)."""
        named = named_tensors(params)
        leaf = next(iter(named.values()))
        with span("train.forward", leaf):
            loss = self.train_loss(params, batch)
        with span("train.backward", leaf):
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

    # ------------------------------------------------------------------
    # abstract inputs per shape cell (fake tensors: no allocation)
    # ------------------------------------------------------------------
    def fake_mode(self):
        """The bundle's ``FakeTensorMode``: every abstract tensor of the
        bundle is made in it, so a trace can take them together."""
        if self._fake is None:
            from torch._subclasses.fake_tensor import FakeTensorMode

            self._fake = FakeTensorMode()
        return self._fake

    def input_specs(self, cell: ShapeCell) -> dict:
        cfg = self.cfg
        B, S = cell.global_batch, cell.seq_len
        i32, bf16 = torch.int32, torch.bfloat16

        def sds(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=self.device)

        with self.fake_mode():
            if cfg.family == "audio":
                if cell.kind == "train":
                    return {
                        "frames": sds((B, WHISPER_TRAIN_ENC, cfg.d_model), bf16),
                        "tokens": sds((B, S), i32),
                        "labels": sds((B, S), i32),
                    }
                if cell.kind == "prefill":
                    return {
                        "frames": sds((B, S, cfg.d_model), bf16),
                        "tokens": sds((B, WHISPER_PREFILL_DEC), i32),
                    }
                cache = encdec.make_encdec_cache(cfg, B, S, cfg.enc_seq, device=self.device)
                return {"cache": cache, "tokens": sds((B, 1), i32)}

            if cfg.family == "vlm":
                P = cfg.num_patches
                if cell.kind == "train":
                    return {
                        "tokens": sds((B, S - P), i32),
                        "labels": sds((B, S - P), i32),
                        "patches": sds((B, P, VIT_DIM), bf16),
                    }
                if cell.kind == "prefill":
                    return {
                        "tokens": sds((B, S - P), i32),
                        "patches": sds((B, P, VIT_DIM), bf16),
                    }
                return {"cache": self.make_cache(B, S, device=self.device),
                        "tokens": sds((B, 1), i32)}

            # plain LM families: dense / moe / ssm / hybrid
            if cell.kind == "train":
                return {"tokens": sds((B, S), i32), "labels": sds((B, S), i32)}
            if cell.kind == "prefill":
                return {"tokens": sds((B, S), i32)}
            return {"cache": self.make_cache(B, S, device=self.device),
                    "tokens": sds((B, 1), i32)}

    def abstract_params(self):
        """The model with fake weights (``init``'s shapes and dtypes)."""
        with self.fake_mode():
            return build_module(self.cfg, self.device, max_dec=self.max_dec)

    def step_for_cell(self, cell: ShapeCell):
        """(callable, abstract-args tuple): the cell's step and its fake
        arguments, as the JAX bundle's are lowered."""
        specs = self.input_specs(cell)
        params = self.abstract_params()
        if cell.kind == "train":
            with self.fake_mode():
                opt = self.init_opt(params)
            fn = lambda p, o, b: self.train_step(p, o, b)  # noqa: E731
            return fn, (params, opt, specs)
        if cell.kind == "prefill":
            fn = lambda p, inputs: self.prefill(p, **inputs)  # noqa: E731
            return fn, (params, specs)
        fn = lambda p, cache, tok: self.decode_step(p, cache, tok)  # noqa: E731
        return fn, (params, specs["cache"], specs["tokens"])


def _max_dec_for(cfg):
    # whisper's learned decoder positions must cover the largest decode cell
    return 32_768


#: whisper's learned encoder positions, as the JAX bundle sizes them
MAX_ENC = 32_768


def build_module(cfg: ArchConfig, device=None, max_dec=None):
    """The family's module on ``device``, weights uninitialised (the audio
    family's decoder position table ``max_dec`` long, by default as
    ``build_model``'s)."""
    if cfg.family in ("dense", "moe", "vlm"):
        return transformer.TransformerLM(cfg, device=device)
    if cfg.family == "ssm":
        return ssm.SSMLM(cfg, device=device)
    if cfg.family == "hybrid":
        return hybrid.HybridLM(cfg, device=device)
    if cfg.family == "audio":
        return encdec.EncDecLM(cfg, device=device, max_dec=max_dec or _max_dec_for(cfg),
                               max_enc=MAX_ENC)
    raise ValueError(f"unknown family {cfg.family!r}")


def _audio_prefill(cfg):
    def prefill(params, *, tokens, frames=None):
        if frames is None:
            raise KeyError(
                f"'frames': {cfg.name} encodes audio frames (B, S_enc, D) before its "
                f"decoder prompt; the serve engine feeds token prompts only, so audio goes "
                f"through bundle.prefill(params, frames=..., tokens=...)")
        return encdec.encdec_prefill(params, frames, tokens, cfg)
    return prefill


def build_model(cfg: ArchConfig, *, max_dec=None, device="cuda") -> ModelBundle:
    """``cfg``'s bundle; ``device`` is where its abstract surface makes its
    fake tensors (``init`` draws on its generator's device)."""
    bundle = _family_bundle(cfg, max_dec)
    return dataclasses.replace(bundle, device=str(device), max_dec=max_dec,
                               prefill=_spanned_prefill(bundle.prefill))


def _spanned_prefill(prefill):
    """``prefill`` inside the program span ``model.prefill``, which ends when
    the model's work is enqueued, whatever wraps the bundle's prefill."""
    @functools.wraps(prefill)
    def run(*args, **kw):
        with span("model.prefill"):
            return prefill(*args, **kw)
    return run


def _family_bundle(cfg: ArchConfig, max_dec) -> ModelBundle:
    f = cfg.family
    if f in ("dense", "moe", "vlm"):
        return ModelBundle(
            cfg=cfg,
            init=functools.partial(transformer.make_lm_params, cfg=cfg),
            train_loss=functools.partial(transformer.lm_train_loss, cfg=cfg),
            prefill=lambda params, *, tokens, cache_len=None, patches=None:
                transformer.lm_prefill(params, tokens, cfg, cache_len=cache_len,
                                       patches=patches),
            decode_step=lambda params, cache, tok: transformer.lm_decode_step(
                params, cache, tok, cfg),
            make_cache=lambda batch, max_len, device="cuda": transformer.make_cache(
                cfg, batch, max_len, device=device),
        )
    if f == "ssm":
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
    if f == "hybrid":
        return ModelBundle(
            cfg=cfg,
            init=functools.partial(hybrid.make_hybrid_params, cfg=cfg),
            train_loss=functools.partial(hybrid.hybrid_train_loss, cfg=cfg),
            # a prompt-sized cache, as the JAX bundle's (the engine pads it)
            prefill=lambda params, *, tokens: hybrid.hybrid_prefill(params, tokens, cfg),
            decode_step=lambda params, cache, tok: hybrid.hybrid_decode_step(
                params, cache, tok, cfg),
            make_cache=lambda batch, max_len, device="cuda": hybrid.make_hybrid_cache(
                cfg, batch, max_len, device=device),
        )
    if f == "audio":
        md = max_dec or _max_dec_for(cfg)
        return ModelBundle(
            cfg=cfg,
            init=lambda generator: encdec.make_encdec_params(generator, cfg, max_dec=md,
                                                             max_enc=MAX_ENC),
            train_loss=functools.partial(encdec.encdec_train_loss, cfg=cfg),
            prefill=_audio_prefill(cfg),
            decode_step=lambda params, cache, tok: encdec.encdec_decode_step(
                params, cache, tok, cfg),
            make_cache=lambda batch, max_len, device="cuda": encdec.make_encdec_cache(
                cfg, batch, max_len, cfg.enc_seq, device=device),
        )
    raise ValueError(f"unknown family {f!r}")


# ---------------------------------------------------------------------------
# analytic parameter counts (MODEL_FLOPS = 6·N·D)
# ---------------------------------------------------------------------------


def analytic_param_count(cfg: ArchConfig, active_only: bool = False) -> int:
    """The parameters of ``cfg``'s model, counted on the ``meta`` device
    (no storage); ``active_only`` subtracts the experts a token does not
    use (k of E in each MoE layer, the hybrid's MoE slots included)."""
    total = sum(p.numel() for p in build_module(cfg, device="meta").parameters())
    if active_only and cfg.is_moe:
        E, K, D, F = cfg.num_experts, cfg.experts_per_token, cfg.d_model, cfg.d_ff
        per_moe_layer = E * 3 * D * F
        if cfg.family == "hybrid":
            n_moe = hybrid.moe_layers(cfg)
        else:
            n_moe = sum(1 for i in range(cfg.num_layers) if i % cfg.moe_period == 0)
        total -= int(n_moe * per_moe_layer * (1 - K / E))
    return total
