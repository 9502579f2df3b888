"""Yi-9B — llama-arch dense GQA LM. [arXiv:2403.04652; hf]"""
from repro_torch.configs.base import ArchConfig, register

YI_9B = register(
    ArchConfig(
        name="yi-9b",
        family="dense",
        source="[arXiv:2403.04652; hf]",
        num_layers=48,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=11008,
        vocab_size=64000,
        rope_theta=10_000.0,
        sharding_preset="fsdp_tp",
        long_context_ok=False,  # pure full attention — long_500k skipped
    )
)
