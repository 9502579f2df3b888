"""The model zoo on torch: every family's serving and training paths —
dense, MoE (with expert parallelism over a mesh's data ranks, ``moe_ep``),
SSM, the Jamba hybrid, the InternVL2 VLM and the Whisper encoder-decoder
(ROADMAP lists what is still to port: the dry run's input specs)."""
from repro_torch.models.model_zoo import ModelBundle, build_model  # noqa: F401
from repro_torch.models.moe_ep import ep_applicable, moe_ffn_bsd_ep  # noqa: F401
