from repro_torch.kernels.decode_attention.decode_attention import (  # noqa: F401
    decode_attention_fwd as decode_attention)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: F401
