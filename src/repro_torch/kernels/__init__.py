"""The port's hand-written CUDA kernels for Hopper, their wrappers, plain
PyTorch versions and ops (counterpart of `repro.kernels`)."""
