"""InternVL2-1B — VLM: InternViT frontend (STUB: precomputed patch embeddings)
+ Qwen2-0.5B-class LM backbone. [arXiv:2404.16821; hf]
"""
from repro_torch.configs.base import ArchConfig, register

INTERNVL2_1B = register(
    ArchConfig(
        name="internvl2-1b",
        family="vlm",
        source="[arXiv:2404.16821; hf]",
        num_layers=24,
        d_model=896,
        num_heads=14,
        num_kv_heads=2,
        head_dim=64,
        d_ff=4864,
        vocab_size=151655,
        frontend="vit_patch",
        num_patches=256,  # patch-embedding prefix provided by input_specs()
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        sharding_preset="dp",
        long_context_ok=False,  # pure full attention
    )
)
