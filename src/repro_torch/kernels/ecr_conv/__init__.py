"""ECR sparse conv: op, CUDA kernel wrapper, plain version, dense oracle."""
