"""Block-sparse matmul: op, CUDA kernel wrapper, plain version, dense oracle."""
