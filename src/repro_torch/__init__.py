"""repro_torch: the sparse-CNN serving system in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The package mirrors `repro`'s module names so each function has an obvious
counterpart, and it imports neither `jax` nor anything from `repro`: the
parity tests are the only code that sees both.

Main path (one request through `launch/serve_cnn.py`):
`serving.batcher.MicroBatcher` -> `serving.plan_cache.PlanCache` ->
`serving.engine.Engine` -> `pipeline.planner.plan_network` / `run_plan` ->
`graph.executor.run_unit` -> the op registry (`graph.registry`), which sends
sparse layers to the ECR kernel (`kernels/ecr_conv`) and sparse stage-final
layers to the fused PECR conv+ReLU+maxpool kernel (`kernels/conv_pool`).

Entry points run on `cuda` unless the caller passes `device="cpu"`; without
a card they raise (`repro_torch.device.resolve_device`). On a CPU tensor a
kernel wrapper runs its plain PyTorch version, on a CUDA tensor it launches
the CUDA kernel.
"""
