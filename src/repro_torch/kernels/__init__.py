"""Kernel wrappers, their CUDA sources and their plain PyTorch versions."""
