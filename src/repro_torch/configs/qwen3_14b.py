"""Qwen3-14B — dense GQA LM with qk-norm. [hf:Qwen/Qwen3-14B; hf]

Widths from the published config (huggingface.co/Qwen/Qwen3-14B,
config.json): 40 layers, hidden 5120, 40 query / 8 KV heads of 128,
intermediate 17408, vocabulary 151936, RoPE theta 1e6, untied embeddings.
"""
from repro_torch.configs.base import ArchConfig, register

QWEN3_14B = register(
    ArchConfig(
        name="qwen3-14b",
        family="dense",
        source="[hf:Qwen/Qwen3-14B; hf]",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=17408,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        sharding_preset="fsdp_tp",
        long_context_ok=False,  # pure full attention — long_500k skipped
        loss_chunk=2048,  # large vocab: chunk the CE over sequence
    )
)
