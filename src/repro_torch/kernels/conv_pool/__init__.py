"""PECR fused conv+ReLU+maxpool: op, CUDA kernel wrapper, plain version, dense oracle."""
