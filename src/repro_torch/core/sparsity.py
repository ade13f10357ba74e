"""Sparsity machinery of the ECR / PECR paths (counterpart of
`repro.core.sparsity`): the im2col window matrix (`extract_windows`), the
paper's element-wise window statistics (`WindowStats`, `window_stats`: the
MAC accounting of paper §IV-D / Fig. 6 and Θ of Fig. 11), synthetic
feature maps, and the block-occupancy schedules the kernels run.

`block_occupancy` marks the blocks holding any nonzero; `compact_block_ids`
turns an occupancy row into the `(ids, cnt)` gather schedule the kernels loop
over — ECR's F_data/Ptr at block granularity. The sort is stable, as in the
reference: an unstable one would change both the schedules and the order in
which the kernels sum.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device


def patches_t(x: torch.Tensor, kh: int, kw: int, stride: int = 1):
    """(N,C,H,W) -> (A^T (C*kh*kw, N*oh*ow), oh, ow): the transposed im2col
    patch matrix of a batch. `F.unfold` lists each window's taps in
    (c, kh, kw) order, the order of `extract_windows` and of the weight
    matrix's columns, so unfold's (N, K, L) permuted to (K, N*L) is already
    A^T; columns run over (n, oh, ow)."""
    n, _, h, w = x.shape
    oh, ow = (h - kh) // stride + 1, (w - kw) // stride + 1
    cols = F.unfold(x, (kh, kw), stride=stride)  # (N, K, oh*ow)
    return cols.transpose(0, 1).reshape(cols.shape[1], n * oh * ow), oh, ow


def extract_windows(x: torch.Tensor, kh: int, kw: int, stride: int = 1) -> torch.Tensor:
    """(C,H,W) -> (n_oh, n_ow, C*kh*kw) window matrix (im2col rows), taps in
    (c, kh, kw) order."""
    if x.ndim == 2:
        x = x[None]
    at, oh, ow = patches_t(x[None], kh, kw, stride)
    return at.T.reshape(oh, ow, -1)


@dataclass(frozen=True)
class WindowStats:
    """MAC accounting for one feature map, paper §IV-D / Fig. 6."""

    n_windows: int
    dense_muls: int
    dense_adds: int
    sparse_muls: int
    sparse_adds: int
    sparsity: float
    theta: float  # paper Fig. 11: Θ = (sparsity*100) / feature-map width

    @property
    def mul_reduction(self) -> float:
        return 1.0 - self.sparse_muls / max(self.dense_muls, 1)

    @property
    def add_reduction(self) -> float:
        return 1.0 - self.sparse_adds / max(self.dense_adds, 1)


def window_stats(x, kh: int, kw: int, stride: int = 1) -> WindowStats:
    """Element-wise window statistics of one (C,H,W) map (a tensor or
    anything `torch.as_tensor` takes), counted on `extract_windows`: each
    window's nonzeros are the multiplies ECR keeps, nonzeros - 1 its adds.
    Counts are integers and the sparsity is zeros / elements, so the result
    does not depend on the device or the summation order."""
    x = torch.as_tensor(x)
    if x.ndim == 2:
        x = x[None]
    wins = extract_windows(x, kh, kw, stride)
    nnz = (wins != 0).sum(-1).reshape(-1)
    n_win = nnz.numel()
    k = wins.shape[-1]
    sparsity = int((x == 0).sum()) / x.numel()
    return WindowStats(
        n_windows=int(n_win),
        dense_muls=int(n_win * k),
        dense_adds=int(n_win * (k - 1)),
        sparse_muls=int(nnz.sum()),
        sparse_adds=int((nnz - 1).clamp(min=0).sum()),
        sparsity=float(sparsity),
        theta=float(sparsity * 100.0 / x.shape[-1]),
    )


def block_occupancy(x: torch.Tensor, block: tuple) -> torch.Tensor:
    """Boolean map: True where the corresponding block of `x` has any nonzero.

    x is cut into blocks along its last len(block) dims (each must divide);
    returns the blocked grid's shape."""
    nb = len(block)
    lead, tail = tuple(x.shape[: x.ndim - nb]), tuple(x.shape[x.ndim - nb:])
    for t, b in zip(tail, block):
        if t % b:
            raise ValueError(f"block {block} does not divide {tail}")
    grid = tuple(t // b for t, b in zip(tail, block))
    xr = x.reshape(lead + tuple(v for tb in zip(grid, block) for v in tb))
    nl = len(lead)
    perm = list(range(nl)) + [nl + 2 * i for i in range(nb)] \
        + [nl + 2 * i + 1 for i in range(nb)]
    xr = xr.permute(perm).reshape(lead + grid + (-1,))
    return (xr != 0).any(dim=-1)


def compact_block_ids(occ: torch.Tensor):
    """ECR compression at block granularity, along the last dim.

    `ids[..., i]` is the index of the i-th live block (live blocks first, in
    their original order), padded with `order[..., 0]` so gathers stay in
    bounds; `cnt[...]` is the number of live blocks. A 1-D `occ` gives a 1-D
    `ids` and a scalar `cnt`; an (N, n) `occ` gives per-row schedules."""
    order = torch.argsort((~occ).to(torch.int8), dim=-1, stable=True)
    count = occ.sum(dim=-1, dtype=torch.int32)
    lane = torch.arange(occ.shape[-1], device=occ.device)
    ids = torch.where(lane < count.unsqueeze(-1), order, order[..., :1])
    return ids.to(torch.int32), count


def occupancy_fraction(occ: torch.Tensor) -> torch.Tensor:
    """The live share of an occupancy map, as a 0-dim float32 tensor."""
    return occ.float().mean()


def dead_channel_band(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Zero the TRAILING `int(C * frac)` channels of a (C,H,W) / (N,C,H,W)
    map — the shared dead-channel band the serving stack calibrates and
    benchmarks with (co-batched requests then share a live-channel union)."""
    c = x.shape[-3]
    n_dead = int(c * frac)
    if n_dead <= 0:
        return x
    mask = (torch.arange(c, device=x.device) < c - n_dead).to(x.dtype)
    return x * mask[:, None, None]


def synth_feature_map(generator: torch.Generator, shape, sparsity: float,
                      dtype=torch.float32, channel_dead_frac: float | None = None,
                      device=None) -> torch.Tensor:
    """Random post-ReLU-like (non-negative) feature map at a target sparsity.

    Part of the sparsity comes from whole dead channels, as in trained nets
    (`channel_dead_frac`, default half the target), the rest from
    unstructured zeros on the surviving channels. Drawn on the host from
    `generator` (its bits differ from the reference's `jax.random` draw;
    parity tests hand both packages the same map), then moved to `device`
    (None = the card)."""
    dev = resolve_device(device)
    shape = tuple(shape)
    vals = torch.rand(shape, generator=generator) * (1.0 - 1e-3) + 1e-3
    if len(shape) == 3 and shape[0] > 1:
        cdf = sparsity * 0.5 if channel_dead_frac is None else channel_dead_frac
        ch_keep = torch.rand((shape[0], 1, 1), generator=generator) >= cdf
        resid = min(max((sparsity - cdf) / max(1.0 - cdf, 1e-6), 0.0), 1.0)
        keep = (torch.rand(shape, generator=generator) >= resid) & ch_keep
    else:
        keep = torch.rand(shape, generator=generator) >= sparsity
    return torch.where(keep, vals, torch.zeros(())).to(dtype).to(dev)
