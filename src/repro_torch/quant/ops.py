"""int8 conv ops and cost hooks: the quantized (kind, impl) family
(counterpart of `repro.quant.ops`).

`ecr_conv_int8` / `conv2d_bsr_int8` mirror their fp32 siblings
(`kernels.ecr_conv.ops.ecr_conv`, `sparse_weights.conv.conv2d_bsr`): the
same compaction, the same schedules, the same geometry resolution at
dtype_bytes=1. Operands are absmax int8 (`repro_torch.quant.quantize`), the
kernels accumulate in int32 and rescale to fp32 at the flush. In and out
dtypes are fp32 like every registry forward, so the planner can put an int8
impl on any layer without touching its neighbours.

The `*_ref` oracles compute the same quantized math with a dense fp32 conv
over the int8 values, so quantization error is isolated to the
oracle-vs-fp32 comparison the planner's accuracy budget governs.

The cost hooks are the reference's, unchanged: int8 arithmetic priced at
half the fp32 FLOPs and operand traffic at 1 byte per element. On the H100
that "2x the fp32 peak" is not the card's ratio (the int8 tensor cores are
far faster than fp32 on CUDA cores); it is kept for plan parity, and the
calibration slice revisits it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.kernels.schedule_guard import guard_schedule
from repro_torch.kernels.tiles import BsrLaunch, ConvLaunch
from repro_torch.quant.kernels import bsr_matmul_int8, ecr_conv_int8_batch
from repro_torch.quant.quantize import (
    absmax_scale,
    quantize_acts,
    quantize_int8,
    quantize_weights,
)


@dataclass(frozen=True)
class Int8Report:
    """Accuracy probe of a plan's int8 placements: dense fp32 logits vs the
    planned-with-int8 logits on the calibration batch."""

    layers: tuple  # conv indices running an int8 impl after planning
    max_logit_drift: float  # max |planned - fp32 dense| over calib logits
    top1_agreement: float  # fraction of calib samples with unchanged argmax
    demoted: tuple = ()  # indices demoted back to fp32 to meet the budget


def ecr_conv_int8_launch(c: int, h: int, w: int, o: int, kh: int = 3,
                         kw: int = 3, *, stride: int = 1, block_c: int = 0,
                         batch: int = 1) -> ConvLaunch:
    """`ConvLaunch` of one int8 ECR conv call: the fp32 builder at
    dtype_bytes=1."""
    from repro_torch.kernels.ecr_conv.ops import ecr_conv_launch

    return ecr_conv_launch(c, h, w, o, kh, kw, stride=stride, block_c=block_c,
                           batch=batch, dtype_bytes=1, kernel="ecr_conv_int8")


def bsr_conv_int8_launch(o: int, k_taps: int, p: int) -> BsrLaunch:
    """`BsrLaunch` of one int8 BSR conv call: the fp32 builder at
    dtype_bytes=1."""
    from repro_torch.sparse_weights.conv import bsr_conv_launch

    return bsr_conv_launch(o, k_taps, p, dtype_bytes=1)


def pack_int8_operands(x_chw: torch.Tensor, kernels_oihw: torch.Tensor,
                       launch: ConvLaunch):
    """The int8 conv kernel's operands for an NCHW batch: shared-union
    channel compaction, then per-sample activation and per-output-channel
    weight quantization, channel padding, NHWC / (kh,kw,C,O) layouts, and
    per-sample schedules on the quantized values. Returns
    (x i8, w i8, sx (N,1), sw (1,O), ids, cnt)."""
    from repro_torch.core.ecr import compact_live_channels_batch
    from repro_torch.kernels.ecr_conv.ops import batch_block_schedule

    bc, cp, n_cb = launch.block_c, launch.c_pad, launch.n_cb
    x_chw, kernels_oihw, _ = compact_live_channels_batch(x_chw, kernels_oihw)
    xq, sx = quantize_acts(x_chw, per_sample=True)  # (N,C,H,W) i8, (N,)
    wq, sw = quantize_weights(kernels_oihw)  # (O,C,kh,kw) i8, (O,)
    x = F.pad(xq, (0, 0, 0, 0, 0, cp)).permute(0, 2, 3, 1).contiguous()
    wk = F.pad(wq, (0, 0, 0, 0, 0, cp)).permute(2, 3, 1, 0).contiguous()
    ids, cnt = batch_block_schedule(x, launch.h, launch.w, bc)
    ids, cnt = guard_schedule(ids, cnt, n_cb)
    return x, wk, sx[:, None], sw[None], ids.contiguous(), cnt.contiguous()


def pack_int8_operands_single(x_chw: torch.Tensor, kernels_oihw: torch.Tensor,
                              launch: ConvLaunch):
    """The single-image (C,H,W) form, as a batch of one with one activation
    scale: after compaction the live channels are a prefix, so ids is the
    identity and cnt = ceil(n_live / bc)."""
    from repro_torch.core.ecr import compact_live_channels

    bc, cp, n_cb = launch.block_c, launch.c_pad, launch.n_cb
    x_chw, kernels_oihw, n_live = compact_live_channels(x_chw, kernels_oihw)
    xq, sx = quantize_acts(x_chw)
    wq, sw = quantize_weights(kernels_oihw)
    x = F.pad(xq, (0, 0, 0, 0, 0, cp)).permute(1, 2, 0).contiguous()[None]
    wk = F.pad(wq, (0, 0, 0, 0, 0, cp)).permute(2, 3, 1, 0).contiguous()
    ids = torch.arange(n_cb, dtype=torch.int32, device=x.device)
    cnt = torch.clamp((n_live + bc - 1) // bc, max=n_cb).to(torch.int32)
    ids, cnt = guard_schedule(ids, cnt, n_cb)
    return (x, wk, sx.reshape(1, 1), sw[None], ids.reshape(1, n_cb).contiguous(),
            cnt.reshape(1).contiguous())


def ecr_conv_int8(x_chw: torch.Tensor, kernels_oihw: torch.Tensor,
                  stride: int = 1, block_c: int = 0) -> torch.Tensor:
    """int8 ECR conv: (C,H,W) x (O,C,kh,kw) -> fp32 (O,oh,ow), skipping dead
    input channel blocks; batched (N,C,H,W) -> (N,O,oh,ow) with per-sample
    schedules and per-sample activation scales. Quantization happens after
    channel compaction (which only permutes channels, so the scales do not
    change) and the block schedule is computed on the quantized values: a
    block that rounds to all zeros is skipped, exactly."""
    if x_chw.ndim == 2:
        x_chw = x_chw[None]
    if kernels_oihw.ndim == 3:
        kernels_oihw = kernels_oihw[None]
    batched = x_chw.ndim == 4
    c, h, w = x_chw.shape[-3:]
    o, _, kh, kw = kernels_oihw.shape
    if batched and x_chw.shape[0] == 0:
        raise ValueError("empty batch: ecr_conv_int8 needs N >= 1")
    launch = ecr_conv_int8_launch(c, h, w, o, kh, kw, stride=stride,
                                  block_c=block_c,
                                  batch=x_chw.shape[0] if batched else 1)
    pack = pack_int8_operands if batched else pack_int8_operands_single
    out = ecr_conv_int8_batch(*pack(x_chw, kernels_oihw, launch), stride=stride,
                              block_c=launch.block_c)
    out = out.permute(0, 3, 1, 2)  # (N, O, oh, ow)
    return out if batched else out[0]


def ecr_conv_int8_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Oracle of the int8 ECR path: dense fp32 conv over the int8 values,
    rescaled."""
    from repro_torch.core.ecr import conv2d_dense

    per_sample = x.ndim == 4
    xq, sx = quantize_acts(x, per_sample=per_sample)
    wq, sw = quantize_weights(w)
    y = conv2d_dense(xq.float(), wq.float(), stride)
    if per_sample:
        return y * sx[:, None, None, None] * sw[None, :, None, None]
    return y * sx * sw[:, None, None]


def pack_bsr_int8_operands(x: torch.Tensor, w: torch.Tensor, stride: int = 1):
    """The int8 BSR kernel's operands for an (N,C,H,W) batch: the quantized
    weight matrix (O,K) with per-row scales sw (O,1), the quantized patch
    matrix A^T (K,P) with one scale sa (1,1), the schedule of the quantized
    weight blocks, and the launch record. Returns
    (wm_q, at_q, sw, sa, ids, cnt, launch, oh, ow)."""
    from repro_torch.core.sparsity import patches_t
    from repro_torch.kernels.bsr_matmul.ops import block_schedule
    from repro_torch.sparse_weights.format import conv_weight_matrix

    o, _, kh, kw = w.shape
    at, oh, ow = patches_t(x.float(), kh, kw, stride)  # (K, P)
    wm = conv_weight_matrix(w).float()  # (O, K)
    launch = bsr_conv_int8_launch(o, at.shape[0], at.shape[1])
    sw = absmax_scale(wm, axis=1)  # (O,) per-row = per-output-channel
    wm_q = quantize_int8(wm, sw[:, None]).contiguous()
    sa = absmax_scale(at)  # scalar, per-tensor patches
    at_q = quantize_int8(at, sa).contiguous()
    ids, cnt = block_schedule(wm_q, launch.bt, launch.bf)
    ids, cnt = guard_schedule(ids, cnt, launch.nf)
    return wm_q, at_q, sw[:, None], sa.reshape(1, 1), ids, cnt, launch, oh, ow


def conv2d_bsr_int8(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """int8 weight-block-sparse conv: the `conv2d_bsr` lowering with the
    quantized weight matrix as the sparse left operand. Weights carry one
    scale per output channel (= per row of W (O,K)), the patches one
    per-tensor scale (over the whole batch); the schedule is computed on the
    quantized weight blocks, so pruned and quantized-to-zero blocks both cost
    nothing. Returns fp32 (O,oh,ow) / (N,O,oh,ow)."""
    single = x.ndim == 3
    if single:
        x = x[None]
    wm_q, at_q, sw, sa, ids, cnt, launch, oh, ow = pack_bsr_int8_operands(x, w, stride)
    yt = bsr_matmul_int8(wm_q, at_q, sw, sa, ids, cnt, block=(launch.bt, launch.bf))
    y = yt.reshape(w.shape[0], x.shape[0], oh, ow).transpose(0, 1)
    return y[0] if single else y


def conv2d_bsr_int8_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Oracle of the int8 BSR path: the same quantization granularity
    (per-tensor patches, per-output-channel weights), dense fp32 conv over
    the quantized values."""
    from repro_torch.core.ecr import conv2d_dense
    from repro_torch.core.sparsity import patches_t
    from repro_torch.sparse_weights.format import conv_weight_matrix

    single = x.ndim == 3
    xs = x[None] if single else x
    _, _, kh, kw = w.shape
    wm = conv_weight_matrix(w).float()
    sw = absmax_scale(wm, axis=1)  # (O,)
    wq = quantize_int8(wm, sw[:, None]).float().reshape(w.shape)
    at, _, _ = patches_t(xs.float(), kh, kw, stride)
    sa = absmax_scale(at)
    xq = quantize_int8(xs, sa).float()
    y = conv2d_dense(xq, wq, stride) * sa * sw[None, :, None, None]
    return y[0] if single else y


# ---------------------------------------------------------------------------
# Cost hooks: the registry's ("conv", "ecr_int8" / "bsr_int8") models
# ---------------------------------------------------------------------------


def ecr_conv_int8_cost(c: int, h: int, w: int, o: int, kh: int = 3,
                       kw: int = 3, *, stride: int = 1, occupancy: float = 1.0,
                       batch: int = 1, dtype_bytes: int = 4) -> dict:
    """`ecr_conv_cost` repriced for int8: operand traffic at 1 byte per
    element (the output still leaves as fp32 at `dtype_bytes`), and
    flops * 0.5 (int8 priced at twice the fp32 rate against the same
    roofline constants)."""
    from repro_torch.kernels.ecr_conv.ops import ecr_conv_cost

    base = ecr_conv_cost(c, h, w, o, kh, kw, stride=stride,
                         occupancy=occupancy, batch=batch, dtype_bytes=1)
    return {"flops": base["flops"] * 0.5,
            "bytes": base["bytes"] + (dtype_bytes - 1.0) * base["out_elems"],
            "out_elems": base["out_elems"]}


def bsr_conv_int8_cost(c: int, h: int, w: int, o: int, kh: int = 3,
                       kw: int = 3, *, stride: int = 1, occupancy: float = 1.0,
                       batch: int = 1, weight_density: float = 1.0,
                       dtype_bytes: int = 4) -> dict:
    """`bsr_conv_cost` repriced for int8 (the same transform as
    `ecr_conv_int8_cost`; weight density keeps scaling the live traffic)."""
    from repro_torch.sparse_weights.conv import bsr_conv_cost

    base = bsr_conv_cost(c, h, w, o, kh, kw, stride=stride,
                         occupancy=occupancy, batch=batch,
                         weight_density=weight_density, dtype_bytes=1)
    return {"flops": base["flops"] * 0.5,
            "bytes": base["bytes"] + (dtype_bytes - 1.0) * base["out_elems"],
            "out_elems": base["out_elems"]}
