"""The benchmark's plain reference: frozen copies of the equations that the
configurations under ``chipbench/configs`` state, in plain PyTorch.

It imports neither ``jax`` nor the JAX package nor anything of the program
under test (``repro_torch``), and takes nothing the program made: the
harness hands it the weights it drew from the seed and the documents and
prompts it generated, and it derives everything else (packed rows, batches,
gradients, optimizer state) itself.

- ``precision``: f32 with TF32 off, and the fp8 control's matmuls.
- ``dense``: the decoder-only transformer with non-parametric LayerNorm
  (OLMo).
- ``ssm``: the Mamba-2 language model (SSD, state-space duality).
- ``train``: packing and batching, the learning-rate schedule, AdamW, and
  the first training steps.
"""
