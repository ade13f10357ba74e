"""Device policy of the port's entry points.

Every entry point takes an explicit `device`. `None` means the card: the port
is written for an NVIDIA GPU, and a host without one raises instead of
quietly running on the CPU. Tests pass `device="cpu"`, where every kernel
wrapper runs its plain PyTorch version.

On the card, fp32 stays fp32: cuDNN convolutions default to TF32, which keeps
about three decimal digits and would move the dense oracle that feeds the
planner's calibration walk (`pipeline.planner.plan_network`), and through it
every reference comparison. `resolve_device` turns TF32 off for both cuDNN
and cuBLAS whenever it hands out a CUDA device. It also keeps cuBLAS's bf16
GEMMs (the trainer's projections and FFN at the reference's default
bfloat16) accumulating in fp32 throughout, with no reduced-precision
split-K reduction: the reference's bf16 dots sum in fp32
(`preferred_element_type=jnp.float32`) and round once.
"""
from __future__ import annotations

import torch


def strict_fp32() -> None:
    """Full-fp32 convolutions and matmuls on the card (no TF32), and bf16
    matmuls that reduce in fp32 only."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device=None) -> torch.device:
    """`device` as a `torch.device`; None -> "cuda". Raises when CUDA is
    asked for (explicitly or by default) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels on the host")
        strict_fp32()
    return dev
