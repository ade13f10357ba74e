"""PECR fused conv+ReLU+maxpool kernel wrapper and its plain PyTorch version.

`conv_pool_batch` replaces
`repro.kernels.conv_pool.kernel.conv_pool_pallas_batch` (and, at N=1 with an
identity-prefix schedule, `conv_pool_pallas`). On a CUDA tensor it launches
the PECR entry point of `repro_torch/kernels/csrc/ecr_conv.cu`, which keeps
the conv result in shared memory and writes only the pooled tile, and counts
the launch in `conv_pool_batch.launches`; on a CPU tensor it runs
`conv_pool_plain`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cuda import check_block_o, launch_conv
from repro_torch.kernels.ecr_conv.kernel import ecr_conv_plain


def conv_pool_plain(x: torch.Tensor, w: torch.Tensor, ids: torch.Tensor,
                    cnt: torch.Tensor, *, stride: int = 1, pool: int = 2,
                    block_c: int) -> torch.Tensor:
    """The fused kernel's function in plain PyTorch: the scheduled ECR conv
    (`ecr_conv_plain`), ReLU, then p x p max-pool at stride p, floored.
    -> (N, OH//p, OW//p, O)."""
    return ecr_conv_plain(x, w, ids, cnt, stride=stride, block_c=block_c,
                          pool=pool)


def conv_pool_batch(x: torch.Tensor, w: torch.Tensor, ids: torch.Tensor,
                    cnt: torch.Tensor, *, stride: int = 1, pool: int = 2,
                    block_c: int, block_o: int = 0) -> torch.Tensor:
    """Batched PECR conv+ReLU+pool: x (N,H,W,C), w (kh,kw,C,O), ids (N,n_cb),
    cnt (N,) -> (N,OH//p,OW//p,O). CUDA tensor: the CUDA kernel, at the
    output-channel tile `block_o` (64 or 128; 0 = its own choice); CPU
    tensor: the plain version."""
    if pool < 1:
        raise ValueError(f"conv_pool_batch needs a pool window >= 1, got {pool}")
    check_block_o(block_o)
    if x.device.type == "cpu":
        return conv_pool_plain(x, w, ids, cnt, stride=stride, pool=pool,
                               block_c=block_c)
    if x.device.type != "cuda":
        raise ValueError(f"conv_pool_batch runs on cuda or cpu, got {x.device}")
    out = launch_conv(x, w, ids, cnt, stride=stride, block_c=block_c, pool=pool,
                      block_o=block_o)
    conv_pool_batch.launches += 1
    return out


conv_pool_batch.launches = 0
