"""Architecture configuration system (a copy of the JAX package's
``repro.configs.base``, which the port does not import).

Every architecture is a frozen ``ArchConfig``; ``reduced()`` derives a tiny
same-family config for CPU tests. The port registers every configuration
of the JAX package: the dense family (``qwen3-14b``, ``olmo-1b``, ``yi-9b``,
``gemma3-4b``), the SSM family (``mamba2-780m``), the MoE family
(``mixtral-8x7b``, ``phi3.5-moe-42b-a6.6b``), the hybrid
(``jamba-1.5-large-398b``; ``granite-4.0-h-small``, which the JAX package
does not have), the VLM (``internvl2-1b``), the audio
encoder-decoder (``whisper-tiny``) and the paper's own presets
``ignis-tiny`` / ``ignis-100m``. ``param_count``/``active_param_count``
are the model zoo's analytic counts.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

# ---------------------------------------------------------------------------
# Input shape cells (assigned): every LM arch pairs with these four shapes.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str
    family: str  # dense | ssm | hybrid | moe | audio | vlm
    source: str  # citation string  [source; verified-tier]

    # transformer backbone
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # attention features
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # SWA window (mixtral)
    local_global_period: int = 0  # gemma3: N local layers then 1 global
    local_window: int = 1024
    attn_logit_softcap: float = 0.0

    # normalisation
    norm_type: str = "rmsnorm"  # rmsnorm | nonparam_ln (olmo)
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_period: int = 1  # MoE layer every N layers (others dense)
    capacity_factor: float = 1.25

    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_groups: int = 1

    # hybrid (jamba): one attention layer per `attn_period` layers
    attn_period: int = 0
    # hybrid with a stated layout (granite-4.0-h): one period's mixers, "M"
    # Mamba-2 and "A" attention, with an MoE FFN in every layer; its length
    # is the period (attn_period is then left 0); "" keeps jamba's
    # (attention first, MoE in the odd slots, dense MLPs elsewhere)
    layer_pattern: str = ""
    moe_shared_ff: int = 0  # width of a shared SwiGLU expert every token takes (0: none)
    moe_dropless: bool = False  # every routed assignment computed: no capacity, no drop

    # scalars of granite's residual stream: embedding x embed_multiplier,
    # each branch x residual_multiplier, logits / logits_scaling; attention
    # scores x attn_scale (0: head_dim^-1/2); the rmsnorms' eps
    embed_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    attn_scale: float = 0.0
    rms_eps: float = 1e-6

    # encoder-decoder (whisper)
    is_encdec: bool = False
    enc_layers: int = 0
    enc_seq: int = 1500  # encoder positions (audio frames after conv stub)

    # modality frontend stub ("audio_conv" | "vit_patch" | None)
    frontend: Optional[str] = None
    num_patches: int = 256  # vlm: image patch-embedding prefix length

    # dtypes / memory policy
    param_dtype: str = "bfloat16"
    opt_moment_dtype: str = "float32"
    remat: str = "full"  # full | dots | none
    loss_chunk: int = 2048  # chunked cross-entropy over seq (0 = off)

    # attention impl
    attn_chunk: int = 1024  # query-chunked attention block size (plain path)
    attn_impl: str = "chunked"  # chunked (plain torch) | flash (CUDA kernel; plain version on CPU)

    # distribution
    sharding_preset: str = "dp"  # dp | fsdp | fsdp_tp | tp (+ "_zero1" suffix)
    attn_sp: bool = False  # sequence-parallel attention (seq over "model")
    grad_accum: int = 1  # microbatch gradient accumulation (activation memory ÷ N)
    moe_ep: bool = False  # expert parallelism: dispatch buffers pinned E-over-"data"
    grad_compress: str = "none"  # none | int8 | topk — DP all-reduce compression
    long_context_ok: bool = False  # may run the long_500k cell
    decode_ok: bool = True  # has a decode step

    def with_overrides(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ---- derived -----------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:  # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    @property
    def hybrid_period(self) -> int:
        """Layers a hybrid period: the stated layout's, else ``attn_period``
        (0: not a hybrid)."""
        return len(self.layer_pattern) or self.attn_period

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6·N·D)."""
        from repro_torch.models.model_zoo import analytic_param_count

        return analytic_param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model_zoo import analytic_param_count

        return analytic_param_count(self, active_only=True)

    def shape_cells(self):
        """The shape cells this arch runs (others are documented skips)."""
        cells = []
        for s in SHAPES.values():
            if s.kind == "decode" and not self.decode_ok:
                continue
            if s.name == "long_500k" and not self.long_context_ok:
                continue
            cells.append(s)
        return cells

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            num_layers=min(self.num_layers, 4) or 0,
            d_model=64,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=16 if self.head_dim else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 256),
            attn_chunk=32,
            loss_chunk=0,
            remat="none",
            sharding_preset="dp",
        )
        if self.is_moe:
            kw.update(num_experts=4, experts_per_token=2)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16)
        if self.is_encdec:
            kw.update(enc_layers=2, enc_seq=64)
        if self.hybrid_period:
            kw.update(num_layers=self.hybrid_period)  # one hybrid block
        if self.moe_shared_ff:
            kw.update(moe_shared_ff=96)
        if self.local_global_period:
            kw.update(num_layers=self.local_global_period + 1, local_window=16)
        if self.sliding_window:
            kw.update(sliding_window=16)
        if self.frontend == "vit_patch":
            kw.update(num_patches=8)
        return self.with_overrides(**kw)


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        import repro_torch.configs  # noqa: F401  (registers all)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)
