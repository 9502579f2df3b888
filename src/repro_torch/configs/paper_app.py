"""Presets used by the paper-analogue examples and the end-to-end driver.

``ignis-100m`` is the ~100M-param LM trained for a few hundred steps by
``examples/hybrid_train.py`` (the paper's "hybrid application" pattern:
dataflow data pipeline feeding an SPMD training job on the same fabric).
"""
from repro_torch.configs.base import ArchConfig, register

IGNIS_100M = register(
    ArchConfig(
        name="ignis-100m",
        family="dense",
        source="[this work]",
        num_layers=8,
        d_model=512,
        num_heads=8,
        num_kv_heads=4,
        head_dim=64,
        d_ff=2048,
        vocab_size=32768,
        rope_theta=10_000.0,
        sharding_preset="dp",
        remat="none",
        param_dtype="float32",
    )
)

IGNIS_TINY = register(
    ArchConfig(
        name="ignis-tiny",
        family="dense",
        source="[this work]",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab_size=4096,
        sharding_preset="dp",
        remat="none",
        param_dtype="float32",
    )
)
