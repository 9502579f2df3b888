"""OLMo-1B — dense LM (MHA: kv==heads), non-parametric LayerNorm.

[arXiv:2402.00838; hf]
"""
from repro_torch.configs.base import ArchConfig, register

OLMO_1B = register(
    ArchConfig(
        name="olmo-1b",
        family="dense",
        source="[arXiv:2402.00838; hf]",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=8192,
        vocab_size=50304,
        norm_type="nonparam_ln",
        tie_embeddings=True,
        sharding_preset="dp",
        long_context_ok=False,  # pure full attention
    )
)
