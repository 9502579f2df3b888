"""Phi-3.5-MoE (42B total / 6.6B active) — 16 experts, top-2.

[hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""
from repro_torch.configs.base import ArchConfig, register

PHI35_MOE = register(
    ArchConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        source="[hf:microsoft/Phi-3.5-MoE-instruct; hf]",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=6400,
        vocab_size=32064,
        num_experts=16,
        experts_per_token=2,
        moe_period=1,  # every layer is MoE
        rope_theta=10_000.0,
        sharding_preset="fsdp_tp",
        long_context_ok=False,  # full attention
    )
)
