"""The paper's contribution as a library (counterpart of `repro.core`).

- ECR sparse convolution (paper §IV): `repro_torch.core.ecr`
- PECR fused conv+ReLU+pool (paper §V): `repro_torch.core.pecr`
- Sparsity machinery (window statistics, block schedules):
  `repro_torch.core.sparsity`
"""
from repro_torch.core.ecr import (
    ECR,
    compact_live_channels,
    compact_live_channels_batch,
    conv2d,
    conv2d_dense,
    conv2d_ecr,
    conv2d_im2col,
    ecr_compress,
    ecr_spmv,
)
from repro_torch.core.pecr import PECR, conv_pool, conv_pool_pecr, conv_pool_unfused, pecr_compress, pecr_conv_pool
from repro_torch.core.sparsity import (
    block_occupancy,
    compact_block_ids,
    dead_channel_band,
    synth_feature_map,
    window_stats,
)

__all__ = [
    "ECR",
    "PECR",
    "block_occupancy",
    "compact_block_ids",
    "compact_live_channels",
    "compact_live_channels_batch",
    "conv2d",
    "conv2d_dense",
    "conv2d_ecr",
    "conv2d_im2col",
    "conv_pool",
    "conv_pool_pecr",
    "conv_pool_unfused",
    "ecr_compress",
    "ecr_spmv",
    "pecr_compress",
    "pecr_conv_pool",
    "dead_channel_band",
    "synth_feature_map",
    "window_stats",
]
