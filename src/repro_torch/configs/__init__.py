"""Architecture configs the port runs (a copy of part of the JAX package's
``repro.configs``). Importing this package registers them;
``get_config(name)`` fetches, and names an architecture that is not ported
yet (ROADMAP: the other families)."""
from repro_torch.configs.base import (ArchConfig, SHAPES, ShapeCell,  # noqa: F401
                                      get_config, list_configs)

from repro_torch.configs import (  # noqa: F401  (registration)
    gemma3_4b,
    mamba2_780m,
    mixtral_8x7b,
    olmo_1b,
    paper_app,
    phi3_5_moe_42b_a6_6b,
    qwen3_14b,
    yi_9b,
)
