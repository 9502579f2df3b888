"""IgnisHPC ported to PyTorch, with hand-written Hopper kernels for the
shuffle engine's wide stages. The JAX package ``repro`` is the reference
this package is held against; nothing here imports it or JAX."""
