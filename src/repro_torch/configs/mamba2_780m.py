"""Mamba2-780M — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ArchConfig, register

MAMBA2_780M = register(
    ArchConfig(
        name="mamba2-780m",
        family="ssm",
        source="[arXiv:2405.21060; unverified]",
        num_layers=48,
        d_model=1536,
        d_ff=0,  # attention-free, no MLP: mamba2 blocks only
        vocab_size=50280,
        ssm_state=128,
        ssm_headdim=64,
        ssm_expand=2,  # d_inner = 3072 → 48 SSD heads
        ssm_chunk=256,
        norm_type="rmsnorm",
        tie_embeddings=True,
        sharding_preset="dp",
        long_context_ok=True,  # O(1) state — flagship long-context arch
    )
)
