"""Hand-written Hopper kernels of the port and their plain PyTorch
versions. CUDA sources live in ``repro_torch/csrc/``; ``_build`` compiles
and binds them on first use."""
