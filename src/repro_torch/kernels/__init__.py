"""CUDA kernels for Hopper, their wrappers and their plain versions."""
