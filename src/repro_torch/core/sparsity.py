"""Block-occupancy machinery of the ECR/PECR schedules and the im2col window
matrix of the BSR conv (counterpart of the block-granularity half of
`repro.core.sparsity`, plus its `extract_windows`).

`block_occupancy` marks the blocks holding any nonzero; `compact_block_ids`
turns an occupancy row into the `(ids, cnt)` gather schedule the kernels loop
over — ECR's F_data/Ptr at block granularity. The sort is stable, as in the
reference: an unstable one would change both the schedules and the order in
which the kernels sum.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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
