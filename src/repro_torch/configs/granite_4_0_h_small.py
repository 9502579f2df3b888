"""Granite-4.0-H-Small (32B total, 9B active) — hybrid Mamba-2 + NoPE GQA
attention, a 72-expert top-10 MoE with a shared expert in every layer.

[hf:ibm-granite/granite-4.0-h-small config.json; hf]. 40 layers as 4
periods of 10 (Mamba-2 x5, attention, Mamba-2 x4: attention at layers 5,
15, 25, 35). Mamba-2: 128 heads of 64, state 128, one group, chunk 256,
conv 4 with bias, expand 2 (d_inner 8192). Attention: 32 query heads and 8
KV heads of 128 (4096 / 32), no positional encoding, scores scaled by
``attention_multiplier`` 1/128. MoE: softmax over the top 10 of 72 router
logits, SwiGLU experts of width 768 (``intermediate_size``), a shared SwiGLU
expert of 1536, no token dropped. Embedding x 12, each branch x 0.22 before
the residual, logits / 16; RMSNorm eps 1e-5; the head tied to the
100,352-row embedding. The JAX package has no counterpart.
"""
from repro_torch.configs.base import ArchConfig, register

GRANITE_4_0_H_SMALL = register(
    ArchConfig(
        name="granite-4.0-h-small",
        family="hybrid",
        source="[hf:ibm-granite/granite-4.0-h-small; hf]",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=768,  # one expert's width
        vocab_size=100352,
        num_experts=72,
        experts_per_token=10,
        moe_shared_ff=1536,
        moe_dropless=True,
        layer_pattern="MMMMMAMMMM",
        ssm_state=128,
        ssm_headdim=64,
        ssm_expand=2,  # d_inner = 8192 → 128 SSD heads
        ssm_chunk=256,
        ssm_conv=4,
        ssm_groups=1,
        rope_theta=0.0,  # position_embedding_type "nope"
        embed_multiplier=12.0,
        residual_multiplier=0.22,
        logits_scaling=16.0,
        attn_scale=0.0078125,
        rms_eps=1e-5,
        tie_embeddings=True,
        sharding_preset="fsdp_tp",
        long_context_ok=True,  # hybrid: KV cache on 4 of 40 layers
    )
)
