"""The model zoo on torch: every family's serving and training paths —
dense, MoE (with expert parallelism over a mesh's data ranks, ``moe_ep``),
SSM, the Jamba hybrid, the InternVL2 VLM and the Whisper encoder-decoder,
and each bundle's abstract surface for the dry run (``input_specs``,
``abstract_params``, ``step_for_cell``: fake tensors, ``launch/dryrun``)."""
from repro_torch.models.model_zoo import ModelBundle, build_model  # noqa: F401
from repro_torch.models.moe_ep import ep_applicable, moe_ffn_bsd_ep  # noqa: F401
