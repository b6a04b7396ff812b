"""Kernels of the port: hand-written CUDA for Hopper plus their plain PyTorch versions."""
