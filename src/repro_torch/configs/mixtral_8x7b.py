"""Mixtral-8x7B — 8 experts top-2 MoE with sliding-window attention.

[arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import ArchConfig, register

MIXTRAL_8X7B = register(
    ArchConfig(
        name="mixtral-8x7b",
        family="moe",
        source="[arXiv:2401.04088; hf]",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        num_experts=8,
        experts_per_token=2,
        moe_period=1,
        sliding_window=4096,  # SWA → bounded KV per layer
        rope_theta=1_000_000.0,
        sharding_preset="fsdp_tp",
        long_context_ok=True,  # SWA is sub-quadratic: window-bounded KV
    )
)
