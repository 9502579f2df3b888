"""Whisper-tiny — encoder-decoder audio transformer; conv frontend is a STUB
(``input_specs`` provides precomputed frame embeddings). [arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ArchConfig, register

WHISPER_TINY = register(
    ArchConfig(
        name="whisper-tiny",
        family="audio",
        source="[arXiv:2212.04356; unverified]",
        num_layers=4,  # decoder layers
        enc_layers=4,
        d_model=384,
        num_heads=6,
        num_kv_heads=6,
        head_dim=64,
        d_ff=1536,
        vocab_size=51865,
        is_encdec=True,
        enc_seq=1500,
        frontend="audio_conv",
        norm_type="layernorm",
        rope_theta=0.0,  # whisper uses learned/sinusoidal positions, not RoPE
        sharding_preset="dp",
        long_context_ok=False,  # full attention decoder
    )
)
