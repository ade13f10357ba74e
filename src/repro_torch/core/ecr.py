"""ECR (Extended & Compressed Row) format and sparse convolution, paper §IV,
plus channel compaction and the dense and im2col baselines (counterpart of
`repro.core.ecr`).

- `ecr_compress` is Algorithm 1: per convolution window, the nonzero
  activations packed to the front of F_data (a stable partition, the order
  the sequential loop writes them in), the co-indexed kernel taps in
  K_data, and Ptr = the nonzero count, -1 for an all-zero window. The tail
  past Ptr is zero in both.
- `ecr_spmv` is Algorithm 2: one SpMV row of length Ptr per output, 0 where
  Ptr = -1.

These are the paper's methods as plain PyTorch oracles: element-wise zero
skipping becomes masking, so they cost what the dense product costs and
more. On the card they run on the card; they never stand in for a kernel.
The profitable realization is the block-sparse CUDA kernel behind
("conv", "ecr_pallas") in `repro_torch.kernels.ecr_conv`.

Layouts: feature maps (C,H,W) or batched (N,C,H,W); kernels (C,kh,kw) for
one output channel or (O,C,kh,kw); VALID padding, any stride (the paper
evaluates 1, 2, 3).

Channel compaction: convolution is invariant under a shared permutation of
x's channels and the kernels' input-channel dim, so a stable live-first
argsort turns channel sparsity into a contiguous prefix of live blocks that
the `(ids, cnt)` schedule then bounds — ECR's "pack nonzeros to the front"
lifted to the channel axis.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.core.sparsity import extract_windows

# Bytes of gathered kernel taps `conv2d_ecr` / `conv_pool_pecr` hold at once
# (output channels are processed in chunks that fit).
ORACLE_WORKSPACE_BYTES = 1 << 30


@dataclass
class ECR:
    """One feature map x one kernel in ECR form (paper Fig. 4). A batched
    `ecr_compress` gives f_data / k_data / ptr a leading batch dim."""

    f_data: torch.Tensor  # (n_oh*n_ow, C*kh*kw) nonzeros packed front
    k_data: torch.Tensor  # (n_oh*n_ow, C*kh*kw) co-indexed kernel taps
    ptr: torch.Tensor  # (n_oh*n_ow,) int32 nonzero count, -1 if window empty
    out_shape: tuple  # (n_oh, n_ow)


def live_first(rows: torch.Tensor):
    """The stable live-first partition of each row (last dim) of `rows`:
    (order, counts int32, live mask of the packed lanes). Zeros sort after
    nonzeros, each group in scan order, as `compact_live_channels` does."""
    nz = rows != 0
    order = torch.argsort((~nz).to(torch.int8), dim=-1, stable=True)
    counts = nz.sum(-1, dtype=torch.int32)
    lane = torch.arange(rows.shape[-1], device=rows.device)
    return order, counts, lane < counts.unsqueeze(-1)


def _compress_windows(x: torch.Tensor, kh: int, kw: int, stride: int):
    """The kernel-independent half of Algorithm 1 for one (C,H,W) map:
    (f_data, order, live, ptr, (oh, ow))."""
    wins = extract_windows(x, kh, kw, stride)  # (oh, ow, K)
    oh, ow, k = wins.shape
    rows = wins.reshape(-1, k)
    order, counts, live = live_first(rows)
    f_data = torch.where(live, rows.gather(1, order), 0)
    ptr = torch.where(counts > 0, counts, -1)
    return f_data, order, live, ptr, (oh, ow)


def ecr_compress(x: torch.Tensor, kernel: torch.Tensor, kh: int, kw: int,
                 stride: int = 1) -> ECR:
    """Algorithm 1 (vectorized over windows): extension and compression.

    x: (C,H,W) one image, or (N,C,H,W) a batch, which gives an ECR whose
    f_data / k_data / ptr carry a leading batch dim (shared out_shape)."""
    if x.ndim == 2:
        x = x[None]
    if kernel.ndim == 2:
        kernel = kernel[None]
    if x.ndim == 4:
        parts = [ecr_compress(xi, kernel, kh, kw, stride) for xi in x]
        return ECR(f_data=torch.stack([p.f_data for p in parts]),
                   k_data=torch.stack([p.k_data for p in parts]),
                   ptr=torch.stack([p.ptr for p in parts]),
                   out_shape=parts[0].out_shape)
    f_data, order, live, ptr, out_shape = _compress_windows(x, kh, kw, stride)
    k_data = torch.where(live, kernel.reshape(-1)[order], 0)
    return ECR(f_data=f_data, k_data=k_data, ptr=ptr, out_shape=out_shape)


def ecr_spmv(ecr: ECR) -> torch.Tensor:
    """Algorithm 2: one SpMV row -> one convolution output.

    Single-image ECR gives (oh, ow), batched (N, oh, ow). Leading dims of
    f_data, k_data and ptr broadcast, so a k_data holding O' kernels' taps
    (O', P, K) over one map's f_data (P, K) gives (O', oh, ow)."""
    lane = torch.arange(ecr.f_data.shape[-1], device=ecr.f_data.device)
    live = lane < ecr.ptr.clamp(min=0).unsqueeze(-1)
    out = torch.where(live, ecr.f_data * ecr.k_data, 0.0).sum(-1)
    out = torch.where(ecr.ptr == -1, 0.0, out)  # Algorithm 2 lines 1-2
    return out.reshape(out.shape[:-1] + tuple(ecr.out_shape))


def out_chunk(per_channel_elems: int, elem_bytes: int = 4) -> int:
    """Output channels whose gathered taps fit `ORACLE_WORKSPACE_BYTES`."""
    return max(1, ORACLE_WORKSPACE_BYTES // max(1, per_channel_elems * elem_bytes))


def compact_live_channels(x: torch.Tensor, kernels: torch.Tensor):
    """(C,H,W) x (O,C,kh,kw): pack live (any-nonzero) input channels into a
    dense prefix. Returns (x_packed, kernels_packed, n_live)."""
    live = (x != 0).flatten(1).any(dim=1)  # (C,)
    order = torch.argsort((~live).to(torch.int8), stable=True)
    n_live = live.sum(dtype=torch.int32)
    return x[order], kernels[:, order], n_live


def compact_live_channels_batch(x: torch.Tensor, kernels: torch.Tensor):
    """Batched compaction with ONE shared permutation over the union of live
    channels across the batch (the kernel tensor stays shared; per-sample
    raggedness comes back through per-sample block schedules). Returns
    (x_packed (N,C,H,W), kernels_packed, n_live_union)."""
    live = (x != 0).transpose(0, 1).flatten(1).any(dim=1)  # (C,)
    order = torch.argsort((~live).to(torch.int8), stable=True)
    n_live = live.sum(dtype=torch.int32)
    return x[:, order], kernels[:, order], n_live


def conv2d_ecr(x: torch.Tensor, kernels: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Sparse convolution via ECR: (C,H,W) -> (O,oh,ow), or batched
    (N,C,H,W) -> (N,O,oh,ow); kernels (O,C,kh,kw), shared across the batch.

    All channels of a window are compressed together, then one SpMV runs
    per output (paper §V-E). The reference compresses once per output
    channel (`vmap` over the kernels); f_data, the order and Ptr depend
    only on x, so here each image is compressed once and K_data is gathered
    from that order for a chunk of output channels at a time
    (`ORACLE_WORKSPACE_BYTES`): the same function, without holding
    O x windows x taps values at once."""
    if kernels.ndim == 3:
        kernels = kernels[None]
    if x.ndim == 2:
        x = x[None]
    o, c, kh, kw = kernels.shape
    kmat = kernels.reshape(o, -1)
    outs = []
    for xi in (x if x.ndim == 4 else x[None]):
        f_data, order, live, ptr, out_shape = _compress_windows(xi, kh, kw, stride)
        step = out_chunk(order.numel())
        parts = []
        for o0 in range(0, o, step):
            k_data = torch.where(live, kmat[o0:o0 + step][:, order], 0)
            parts.append(ecr_spmv(ECR(f_data, k_data, ptr, out_shape)))
        outs.append(torch.cat(parts))
    return torch.stack(outs) if x.ndim == 4 else outs[0]


def conv2d_dense(x: torch.Tensor, kernels: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Dense VALID conv (the cuDNN baseline): (C,H,W) -> (O,oh,ow) or
    (N,C,H,W) -> (N,O,oh,ow). On the card it runs in full fp32: the
    entry points turn TF32 off (`repro_torch.device.resolve_device`)."""
    if kernels.ndim == 3:
        kernels = kernels[None]
    batched = x.ndim == 4
    out = F.conv2d((x if batched else x[None]).float(), kernels.float(),
                   stride=stride)
    return out if batched else out[0]


def conv2d_im2col(x: torch.Tensor, kernels: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """im2col + GEMM baseline (paper §VII "im2col"): the window matrix of
    each image materialized, then one (P, K) x (K, O) product."""
    if x.ndim == 2:
        x = x[None]
    if kernels.ndim == 3:
        kernels = kernels[None]
    if x.ndim == 4:
        return torch.stack([conv2d_im2col(xi, kernels, stride) for xi in x])
    o, c, kh, kw = kernels.shape
    wins = extract_windows(x, kh, kw, stride)  # (oh, ow, K)
    oh, ow, k = wins.shape
    return (wins.reshape(-1, k) @ kernels.reshape(o, k).T).T.reshape(o, oh, ow)


def conv2d(x, kernels, stride: int = 1, impl: str = "dense") -> torch.Tensor:
    """Multi-impl conv entry point; the dispatch is the op registry's
    (`repro_torch.graph.registry`)."""
    from repro_torch.graph.registry import get_op

    return get_op("conv", impl).forward(x, kernels, stride=stride)
