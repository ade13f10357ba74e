"""Host-side (ids, cnt) bounds guard at the op entry points (counterpart of
`repro.kernels.schedule_guard`).

The kernels trust their schedules: an out-of-range id gathers the wrong
channel block (on the card, memory outside the input), and a cnt beyond
n_blocks walks off the schedule. With REPRO_CHECK_SCHEDULES=1 the ops clamp
both into range before launching; on valid schedules the clamp is the
identity, and with the guard off nothing is added.

A valid schedule also lists each block at most once among its live lanes.
The Pallas kernels add a block once per listing, the BSR kernel and its
plain version once, so a repeated block has no one answer: the guard
refuses it (ValueError) instead of clamping.
"""
from __future__ import annotations

import os

import torch


def schedules_checked() -> bool:
    """Whether the REPRO_CHECK_SCHEDULES=1 guard is on (read per call)."""
    return os.environ.get("REPRO_CHECK_SCHEDULES", "") == "1"


def repeated_blocks(ids: torch.Tensor, cnt: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """(rows,) bool: whether schedule row i lists an in-range block twice
    among its live lanes ids[i, :cnt[i]]. ids (..., L) with cnt (...)."""
    cnt = cnt.reshape(-1)
    ids = ids.reshape(cnt.numel(), -1).long()
    lane = torch.arange(ids.shape[1], device=ids.device)
    live = (lane[None, :] < cnt.clamp(0, n_blocks)[:, None]) & (ids >= 0) & (ids < n_blocks)
    hits = torch.zeros((ids.shape[0], max(n_blocks, 1)), dtype=torch.int32, device=ids.device)
    hits.scatter_add_(1, ids.clamp(0, max(n_blocks - 1, 0)), live.to(torch.int32))
    return (hits > 1).any(1)


def guard_schedule(ids: torch.Tensor, cnt: torch.Tensor, n_blocks: int):
    """When the guard is on: refuse a schedule that repeats a block, then
    clamp ids into [0, n_blocks) and cnt into [0, n_blocks]."""
    if not schedules_checked():
        return ids, cnt
    bad = repeated_blocks(ids, cnt, n_blocks)
    if bool(bad.any()):
        rows = bad.nonzero().flatten()[:8].tolist()
        raise ValueError(f"schedule rows {rows} list a block more than once")
    ids = torch.clamp(ids, 0, max(n_blocks - 1, 0)).to(ids.dtype)
    cnt = torch.clamp(cnt, 0, n_blocks).to(cnt.dtype)
    return ids, cnt
