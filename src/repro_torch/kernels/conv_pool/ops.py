"""PECR fused conv+ReLU+maxpool op (counterpart of
`repro.kernels.conv_pool.ops`).

Registered as ("conv_pool", "pecr_pallas") in `repro_torch.graph.registry`
(forward = `fused_conv_pool`, cost hook = `conv_pool_cost`). The kernel form
needs pooling stride == pool size; the registry's `fusion_eligible` rule only
routes units here when that and exact tiling hold.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.conv_pool.kernel import conv_pool_batch
from repro_torch.kernels.ecr_conv.ops import (
    ecr_conv_cost,
    ecr_conv_launch,
    pack_operands,
    pack_operands_single,
)
from repro_torch.kernels.tiles import ConvLaunch, TileConfig, resolve_block_o


def conv_pool_launch(c: int, h: int, w: int, o: int, kh: int = 3, kw: int = 3,
                     *, stride: int = 1, pool: int = 2, block_c: int = 0,
                     tile: TileConfig | None = None, batch: int = 1,
                     dtype_bytes: int = 4) -> ConvLaunch:
    """`ConvLaunch` of one fused PECR call: the ECR builder with the pool
    window recorded."""
    return ecr_conv_launch(c, h, w, o, kh, kw, stride=stride, block_c=block_c,
                           tile=tile, batch=batch, dtype_bytes=dtype_bytes,
                           pool=pool, kernel="conv_pool")


def fused_conv_pool(x_chw: torch.Tensor, kernels_oihw: torch.Tensor,
                    stride: int = 1, pool: int = 2, p_s=None, block_c: int = 0,
                    block_o: int = 0):
    """(C,H,W) x (O,C,kh,kw) -> (O, oh//p, ow//p); batched (N,C,H,W) ->
    (N, O, oh//p, ow//p). p_s (the pool stride) must equal pool. `block_o`
    asks the kernel for its output-channel tile, as in `ecr_conv`."""
    if p_s is not None and p_s != pool:
        raise ValueError(f"fused conv+pool needs pooling stride == pool, got "
                         f"stride {p_s} for a {pool}x{pool} pool")
    if x_chw.ndim == 2:
        x_chw = x_chw[None]
    if kernels_oihw.ndim == 3:
        kernels_oihw = kernels_oihw[None]
    batched = x_chw.ndim == 4
    c, h, w = x_chw.shape[-3:]
    o, _, kh, kw = kernels_oihw.shape
    if batched and x_chw.shape[0] == 0:
        raise ValueError("empty batch: fused_conv_pool needs N >= 1")
    launch = conv_pool_launch(c, h, w, o, kh, kw, stride=stride, pool=pool,
                              block_c=block_c,
                              batch=x_chw.shape[0] if batched else 1,
                              dtype_bytes=x_chw.element_size())
    pack = pack_operands if batched else pack_operands_single
    x, wk, ids, cnt = pack(x_chw, kernels_oihw, launch)
    out = conv_pool_batch(x, wk, ids, cnt, stride=stride, pool=pool,
                          block_c=launch.block_c,
                          block_o=resolve_block_o(o, block_o))
    out = out.permute(0, 3, 1, 2)
    return out if batched else out[0]


def conv_pool_cost(c: int, h: int, w: int, o: int, kh: int = 3, kw: int = 3, *,
                   stride: int = 1, pool: int = 2, occupancy: float = 1.0,
                   batch: int = 1, dtype_bytes: int = 4) -> dict:
    """Modeled FLOPs / HBM bytes of the fused PECR conv+ReLU+pool: the ECR
    cost with the output write divided by pool^2 (only the pooled tile is
    written) plus ~1 op per conv output element for the max."""
    base = ecr_conv_cost(c, h, w, o, kh, kw, stride=stride, occupancy=occupancy,
                         batch=batch, dtype_bytes=dtype_bytes)
    oh, ow = (h - kh) // stride + 1, (w - kw) // stride + 1
    conv_out_bytes = o * oh * ow * dtype_bytes * batch
    pooled_bytes = o * (oh // pool) * (ow // pool) * dtype_bytes * batch
    return {"flops": base["flops"] + o * oh * ow * batch,
            "bytes": base["bytes"] - conv_out_bytes + pooled_bytes,
            "out_elems": o * (oh // pool) * (ow // pool) * batch}
