"""conv2d_bsr: weight-block-sparse convolution, im2col onto the BSR kernel
(counterpart of `repro.sparse_weights.conv`).

The patches of the (padded) input form A^T (K, P) with K = C*kh*kw and
P = N*oh*ow, the weight is viewed as W (O, K), and

    y^T = W @ A^T

runs on the block-sparse matmul kernel with W as the sparse LEFT operand:
the (ids, cnt) schedule over W's (bt, bf) blocks (fixed once the weights
are, since pruning is offline) gathers only the live weight blocks, so a
pruned-away block costs neither its multiply-adds nor the read of the patch
rows it would have met. `conv2d_bsr_ref` is the dense conv on the same
(pruned) weights: zeros contribute zero, so the two agree to fp32 tolerance
on any weights.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparsity import patches_t
from repro_torch.kernels.bsr_matmul.kernel import bsr_matmul
from repro_torch.kernels.bsr_matmul.ops import block_schedule
from repro_torch.kernels.schedule_guard import guard_schedule
from repro_torch.kernels.tiles import BsrLaunch, resolve_bsr_tile
from repro_torch.sparse_weights.format import conv_weight_matrix


def bsr_conv_launch(o: int, k_taps: int, p: int, *, tile=None,
                    dtype_bytes: int = 4) -> BsrLaunch:
    """The resolved `BsrLaunch` of one conv2d_bsr call: the (O, K) weight
    against (K, P) patches at `resolve_bsr_tile`'s geometry for `tile` (a
    `TileConfig` or None; the op reads its block sizes back out of this
    record)."""
    bt, bf = resolve_bsr_tile(o, k_taps, p, tile)
    return BsrLaunch(t=o, f=k_taps, d=p, bt=bt, bf=bf, nt=-(-o // bt),
                     nf=-(-k_taps // bf), dtype_bytes=dtype_bytes)


def conv2d_bsr_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Dense conv on the (possibly pruned) weights, VALID padding:
    (C,H,W) -> (O,oh,ow) or (N,C,H,W) -> (N,O,oh,ow)."""
    from repro_torch.core.ecr import conv2d_dense

    return conv2d_dense(x, w, stride)


def pack_bsr_operands(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                      tile=None):
    """The BSR kernel's operands for an (N,C,H,W) batch: the weight matrix
    W (O,K), the patch matrix A^T (K, N*oh*ow), W's (ids, cnt) schedule at
    `tile`'s block geometry and the launch record. Returns
    (wm, at, ids, cnt, launch, oh, ow)."""
    o, _, kh, kw = w.shape
    at, oh, ow = patches_t(x.float(), kh, kw, stride)  # (K, P)
    wm = conv_weight_matrix(w).float().contiguous()  # (O, K)
    launch = bsr_conv_launch(o, at.shape[0], at.shape[1], tile=tile)
    ids, cnt = block_schedule(wm, launch.bt, launch.bf)
    ids, cnt = guard_schedule(ids, cnt, launch.nf)
    return wm, at.contiguous(), ids, cnt, launch, oh, ow


def conv2d_bsr(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
               tile=None) -> torch.Tensor:
    """Weight-block-sparse conv. x: (C,H,W) or (N,C,H,W), already padded
    (VALID semantics, like every registry conv forward); w: (O,C,kh,kw).
    Returns fp32 (O,oh,ow) / (N,O,oh,ow).

    Activation sparsity is not exploited: every patch is read. The planner
    trades the two (BSR wins when the weight density undercuts the measured
    activation occupancy). `tile` (a `TileConfig`) sets the reduction block
    bf by `resolve_bsr_tile`'s rule; the schedule is computed on the weight
    values at that block, so every geometry gives the same product."""
    single = x.ndim == 3
    if single:
        x = x[None]
    wm, at, ids, cnt, launch, oh, ow = pack_bsr_operands(x, w, stride, tile)
    yt = bsr_matmul(wm, at, ids, cnt, block=(launch.bt, launch.bf))
    y = yt.reshape(w.shape[0], x.shape[0], oh, ow).transpose(0, 1)  # y^T -> y
    return y[0] if single else y


def bsr_conv_cost(c: int, h: int, w: int, o: int, kh: int = 3, kw: int = 3, *,
                  stride: int = 1, occupancy: float = 1.0, batch: int = 1,
                  weight_density: float = 1.0, dtype_bytes: int = 4) -> dict:
    """Modeled FLOPs / HBM bytes of the BSR conv at a static weight block
    density: a dead weight block skips its MACs, its weight bytes and the
    activation taps it would have read, so activation bytes scale by
    `weight_density` (the activation `occupancy` buys nothing) and the weight
    read amortizes over the batch. Spatial dims are the padded input."""
    del occupancy  # BSR reads every window: activation sparsity buys nothing
    oh, ow = (h - kh) // stride + 1, (w - kw) // stride + 1
    wd = weight_density
    flops = 2.0 * oh * ow * o * c * kh * kw * wd * batch
    act_bytes = wd * c * h * w * dtype_bytes * batch
    out_bytes = o * oh * ow * dtype_bytes * batch
    k_bytes = wd * o * c * kh * kw * dtype_bytes  # read once per batch
    return {"flops": flops, "bytes": act_bytes + out_bytes + k_bytes,
            "out_elems": o * oh * ow * batch}
