"""The model zoo on torch: the dense transformer family's serving path
(ROADMAP lists what is still to port: the training path, the other
families, ``moe_ep``)."""
from repro_torch.models.model_zoo import ModelBundle, build_model  # noqa: F401
