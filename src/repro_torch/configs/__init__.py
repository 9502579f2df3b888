"""Architecture configs (a copy of the JAX package's ``repro.configs``).
Importing this package registers every config; ``get_config(name)``
fetches."""
from repro_torch.configs.base import (ArchConfig, SHAPES, ShapeCell,  # noqa: F401
                                      get_config, list_configs)

from repro_torch.configs import (  # noqa: F401  (registration)
    gemma3_4b,
    internvl2_1b,
    jamba_1_5_large_398b,
    mamba2_780m,
    mixtral_8x7b,
    olmo_1b,
    paper_app,
    phi3_5_moe_42b_a6_6b,
    qwen3_14b,
    whisper_tiny,
    yi_9b,
)
