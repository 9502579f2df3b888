"""The model zoo on torch: every family's serving and training paths —
dense, MoE, SSM, the Jamba hybrid, the InternVL2 VLM and the Whisper
encoder-decoder (ROADMAP lists what is still to port: ``moe_ep``, the dry
run's input specs)."""
from repro_torch.models.model_zoo import ModelBundle, build_model  # noqa: F401
