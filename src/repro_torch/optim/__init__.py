"""The optimizer of the training path: AdamW on tensors and the learning
rate schedule (the port of ``repro.optim``)."""
from repro_torch.optim.adamw import adamw_update, init_opt_state  # noqa: F401
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
