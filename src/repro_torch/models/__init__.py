"""The model zoo on torch: the dense transformer family's serving path
(ROADMAP A.8 lists what is still to port)."""
from repro_torch.models.model_zoo import ModelBundle, build_model  # noqa: F401
