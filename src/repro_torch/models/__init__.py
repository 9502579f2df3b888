"""The model zoo on torch: the dense, MoE and SSM families' serving and
training paths (ROADMAP lists what is still to port: the other families,
``moe_ep``, the dry run's input specs)."""
from repro_torch.models.model_zoo import ModelBundle, build_model  # noqa: F401
