"""Tensor ops of the port. Kernel modules: ``patches`` (B1/B2) and
``fused_multislice`` (B3); ``_build`` compiles their CUDA sources."""
