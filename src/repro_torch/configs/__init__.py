"""Architecture configs (a copy of the JAX package's ``repro.configs``).
Importing this package registers every config; ``get_config(name)``
fetches."""
from repro_torch.configs.base import (ArchConfig, SHAPES, ShapeCell,  # noqa: F401
                                      get_config, list_configs)

from repro_torch.configs import (  # noqa: F401  (registration)
    gemma3_4b,
    granite_4_0_h_small,
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

#: the architectures the dry run sweeps (``launch/dryrun --all``)
ASSIGNED = [
    "yi-9b",
    "qwen3-14b",
    "gemma3-4b",
    "olmo-1b",
    "mamba2-780m",
    "whisper-tiny",
    "jamba-1.5-large-398b",
    "internvl2-1b",
    "phi3.5-moe-42b-a6.6b",
    "mixtral-8x7b",
]
