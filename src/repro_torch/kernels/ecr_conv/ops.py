"""ECR conv op: channel compaction, per-sample (ids, cnt) schedules, and the
kernel launch (counterpart of `repro.kernels.ecr_conv.ops`).

Registered as ("conv", "ecr_pallas") in `repro_torch.graph.registry`
(forward = `ecr_conv`, cost hook = `ecr_conv_cost`). The impl string keeps the
reference's name so plan signatures compare one to one; on the card it runs
the CUDA kernel (`kernel.ecr_conv_batch`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.ecr import compact_live_channels, compact_live_channels_batch
from repro_torch.core.sparsity import block_occupancy, compact_block_ids
from repro_torch.kernels.ecr_conv.kernel import ecr_conv_batch
from repro_torch.kernels.schedule_guard import guard_schedule
from repro_torch.kernels.tiles import (
    ConvLaunch,
    TileConfig,
    f32_conv_tile,
    i8_conv_tile,
    resolve_block_c,
    resolve_block_o,
    resolve_conv_tile,
)


def ecr_conv_launch(c: int, h: int, w: int, o: int, kh: int = 3, kw: int = 3,
                    *, stride: int = 1, block_c: int = 0, block_o: int = 0,
                    tile: TileConfig | None = None, batch: int = 1,
                    dtype_bytes: int = 4, pool: int = 0,
                    kernel: str = "ecr_conv") -> ConvLaunch:
    """The resolved `ConvLaunch` of one ECR conv call: the schedule's block
    size through `resolve_block_c` (exactly the resolution `ecr_conv` runs
    with, at the operands' `dtype_bytes`), the channel padding and schedule
    length derived once, and the CUDA kernel's tile and grid on an H100
    (`f32_conv_tile`, at the output tile `resolve_block_o` asks for; the
    int8 kernel's `i8_conv_tile`, whose output tile is fixed). `tile` wins
    over the `block_c` / `block_o` scalars."""
    t = tile if tile is not None else TileConfig(block_c=block_c, block_o=block_o)
    bc = resolve_block_c(h, w, c, t, dtype_bytes)
    cp = (-c) % bc
    oh, ow = (h - kh) // stride + 1, (w - kw) // stride + 1
    if dtype_bytes == 1:
        tn_req, geom = 0, i8_conv_tile(oh, ow, o, kh, kw, stride)
        contract = dict(acc_dtype="int32", weight_scales="per_output_channel")
    else:
        tn_req = resolve_block_o(o, t.block_o)
        geom = f32_conv_tile(batch, oh, ow, o, kh, kw, stride, pool, tn_req)
        contract = {}
    tm, tn, th, tw, tiles, o_tiles, smem = geom
    return ConvLaunch(
        kernel=kernel, batch=batch, c=c, h=h, w=w, o=o, kh=kh, kw=kw,
        stride=stride, pool=pool, block_c=bc, c_pad=cp, n_cb=(c + cp) // bc,
        oh=oh, ow=ow, dtype_bytes=dtype_bytes, tn_req=tn_req, tm=tm, tn=tn,
        th=th, tw=tw, tiles=tiles, o_tiles=o_tiles, smem_bytes=smem, **contract)


def batch_block_schedule(x_nhwc: torch.Tensor, h: int, w: int, bc: int):
    """Per-sample (ids, cnt) channel-block schedules of a batched (N,H,W,C')
    tensor: each sample skips its own dead blocks. ids (N, n_cb), cnt (N,)."""
    n = x_nhwc.shape[0]
    occ = block_occupancy(x_nhwc, (h, w, bc)).reshape(n, -1)  # (N, n_cb)
    return compact_block_ids(occ)


def pack_operands(x_chw: torch.Tensor, kernels_oihw: torch.Tensor,
                  launch: ConvLaunch):
    """The kernels' operands for an NCHW batch: shared-union channel
    compaction, channel padding to a block_c multiple, NHWC / (kh,kw,C,O)
    layouts, and per-sample schedules. Returns (x, w, ids, cnt)."""
    bc, cp, n_cb = launch.block_c, launch.c_pad, launch.n_cb
    x_chw, kernels_oihw, _ = compact_live_channels_batch(x_chw, kernels_oihw)
    x = F.pad(x_chw, (0, 0, 0, 0, 0, cp)).permute(0, 2, 3, 1).contiguous()
    wk = F.pad(kernels_oihw, (0, 0, 0, 0, 0, cp)).permute(2, 3, 1, 0).contiguous()
    ids, cnt = batch_block_schedule(x, launch.h, launch.w, bc)
    ids, cnt = guard_schedule(ids, cnt, n_cb)
    return x, wk, ids.contiguous(), cnt.contiguous()


def pack_operands_single(x_chw: torch.Tensor, kernels_oihw: torch.Tensor,
                         launch: ConvLaunch):
    """The single-image (C,H,W) form, as a batch of one: after compaction the
    live channels are a prefix, so ids is the identity and
    cnt = ceil(n_live / bc). Returns (x (1,H,W,C'), w, ids (1,n_cb), cnt (1,))."""
    bc, cp, n_cb = launch.block_c, launch.c_pad, launch.n_cb
    x_chw, kernels_oihw, n_live = compact_live_channels(x_chw, kernels_oihw)
    x = F.pad(x_chw, (0, 0, 0, 0, 0, cp)).permute(1, 2, 0).contiguous()[None]
    wk = F.pad(kernels_oihw, (0, 0, 0, 0, 0, cp)).permute(2, 3, 1, 0).contiguous()
    ids = torch.arange(n_cb, dtype=torch.int32, device=x.device)
    cnt = torch.clamp((n_live + bc - 1) // bc, max=n_cb).to(torch.int32)
    ids, cnt = guard_schedule(ids, cnt, n_cb)
    return x, wk, ids.reshape(1, n_cb).contiguous(), cnt.reshape(1).contiguous()


def ecr_conv(x_chw: torch.Tensor, kernels_oihw: torch.Tensor, stride: int = 1,
             block_c: int = 0, block_o: int = 0):
    """(C,H,W) x (O,C,kh,kw) -> (O,oh,ow), skipping dead input channel blocks.
    Batched: (N,C,H,W) -> (N,O,oh,ow) with per-sample schedules over one
    shared-union compaction (kernels stay shared across the batch).
    `block_o` asks the CUDA kernel for its output-channel tile
    (`resolve_block_o`: 64 or 128 where the layer has the channels, else its
    own choice); the values do not depend on it. The reference's
    `compact=False` is not ported: every caller compacts."""
    if x_chw.ndim == 2:
        x_chw = x_chw[None]
    if kernels_oihw.ndim == 3:
        kernels_oihw = kernels_oihw[None]
    batched = x_chw.ndim == 4
    c, h, w = x_chw.shape[-3:]
    o, _, kh, kw = kernels_oihw.shape
    if batched and x_chw.shape[0] == 0:
        raise ValueError("empty batch: ecr_conv needs N >= 1")
    launch = ecr_conv_launch(c, h, w, o, kh, kw, stride=stride,
                             block_c=block_c, block_o=block_o,
                             batch=x_chw.shape[0] if batched else 1,
                             dtype_bytes=x_chw.element_size())
    pack = pack_operands if batched else pack_operands_single
    x, wk, ids, cnt = pack(x_chw, kernels_oihw, launch)
    out = ecr_conv_batch(x, wk, ids, cnt, stride=stride, block_c=launch.block_c,
                         block_o=launch.tn_req)
    out = out.permute(0, 3, 1, 2)  # (N, O, oh, ow)
    return out if batched else out[0]


def ecr_conv_cost(c: int, h: int, w: int, o: int, kh: int = 3, kw: int = 3, *,
                  stride: int = 1, occupancy: float = 1.0, batch: int = 1,
                  dtype_bytes: int = 4) -> dict:
    """Modeled FLOPs / HBM bytes of the gathered-schedule ECR conv at a given
    channel-block occupancy (1.0 models the dense path). Skipped blocks save
    both the MACs and the activation/weight reads; the weights are read once
    per batch. h/w are the padded input dims. Totals for the whole batch."""
    oh, ow = (h - kh) // stride + 1, (w - kw) // stride + 1
    flops = 2.0 * oh * ow * o * c * kh * kw * occupancy * batch
    act_bytes = occupancy * c * h * w * dtype_bytes * batch
    out_bytes = o * oh * ow * dtype_bytes * batch
    k_bytes = occupancy * o * c * kh * kw * dtype_bytes
    return {"flops": flops, "bytes": act_bytes + out_bytes + k_bytes,
            "out_elems": o * oh * ow * batch}


def channel_block_occupancy(x_chw: torch.Tensor, block_c: int = 128,
                            compact: bool = False) -> float:
    """Fraction of live channel blocks of a (C, H, W) map: the share of the
    kernel's work its schedule does not skip, at the block size `ecr_conv`
    resolves for this shape (`resolve_conv_tile`). A block_c that does not
    divide C pads the tail channels up to a whole block. compact=True gives
    the occupancy after channel compaction, ceil(n_live / bc) / n_blocks."""
    c, h, w = x_chw.shape
    bc = resolve_conv_tile(h, w, c, c, TileConfig(block_c=block_c))[0]
    n_cb = -(-c // bc)
    if compact:
        n_live = int((x_chw != 0).flatten(1).any(1).sum())
        return -(-n_live // bc) / n_cb
    xp = F.pad(x_chw, (0, 0, 0, 0, 0, n_cb * bc - c))
    occ = block_occupancy(xp.permute(1, 2, 0), (h, w, bc))
    return float(occ.float().mean())
