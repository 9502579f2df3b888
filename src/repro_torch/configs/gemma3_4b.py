"""Gemma3-4B — dense GQA LM, 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt; unverified]

The citation is the JAX config's: it names the 1B model's card while the
widths are the 4B model's. It stays as the JAX package has it, unverified
(ROADMAP C), until a published config is checked against these fields.
"""
from repro_torch.configs.base import ArchConfig, register

GEMMA3_4B = register(
    ArchConfig(
        name="gemma3-4b",
        family="dense",
        source="[hf:google/gemma-3-1b-pt; unverified]",
        num_layers=34,
        d_model=2560,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=10240,
        vocab_size=262144,
        local_global_period=5,  # 5 local layers then 1 global (pattern LLLLLG)
        local_window=1024,
        rope_theta=1_000_000.0,
        attn_logit_softcap=50.0,
        sharding_preset="fsdp_tp",
        # 5:1 local:global — local layers bounded; decode against sharded KV for
        # the global layers is O(L)/token, so the long_500k decode cell runs.
        long_context_ok=True,
        loss_chunk=1024,  # 262k vocab: chunk the CE over sequence
        tie_embeddings=True,
    )
)
