"""Jamba-1.5-Large (398B total) — hybrid Mamba+attention 1:7 interleave + MoE.

[arXiv:2403.19887; hf]. Structural approximation (documented in DESIGN.md):
period-8 blocks (1 attention + 7 mamba layers), MoE every 2 layers (16 experts,
top-2); 72 layers = 9 scanned blocks. Optimizer moments kept in bf16 to fit
HBM at 256 chips (beyond-paper memory policy, see EXPERIMENTS.md §Perf).
"""
from repro_torch.configs.base import ArchConfig, register

JAMBA_1_5_LARGE = register(
    ArchConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        source="[arXiv:2403.19887; hf]",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=65536,
        num_experts=16,
        experts_per_token=2,
        moe_period=2,
        attn_period=8,  # 1 attention layer per 8 (1:7 attn:mamba)
        ssm_state=128,
        ssm_headdim=64,
        ssm_expand=2,  # d_inner = 16384 → 256 SSD heads
        ssm_chunk=256,
        rope_theta=0.0,  # jamba uses no positional encoding on attention
        sharding_preset="fsdp_tp",
        long_context_ok=True,  # hybrid: KV cache only on 1/8 of layers
        opt_moment_dtype="bfloat16",
        loss_chunk=2048,
    )
)
