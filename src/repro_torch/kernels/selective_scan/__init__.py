"""Mamba selective scan: the CUDA kernel's wrapper and its plain PyTorch
version."""
