"""Host-side (ids, cnt) bounds guard at the op entry points (counterpart of
`repro.kernels.schedule_guard`).

The kernels trust their schedules: an out-of-range id gathers the wrong
channel block (on the card, memory outside the input), and a cnt beyond
n_blocks walks off the schedule. With REPRO_CHECK_SCHEDULES=1 the ops clamp
both into range before launching; on valid schedules the clamp is the
identity, and with the guard off nothing is added.
"""
from __future__ import annotations

import os

import torch


def schedules_checked() -> bool:
    """Whether the REPRO_CHECK_SCHEDULES=1 guard is on (read per call)."""
    return os.environ.get("REPRO_CHECK_SCHEDULES", "") == "1"


def guard_schedule(ids: torch.Tensor, cnt: torch.Tensor, n_blocks: int):
    """Clamp ids into [0, n_blocks) and cnt into [0, n_blocks] when the guard is on."""
    if not schedules_checked():
        return ids, cnt
    ids = torch.clamp(ids, 0, max(n_blocks - 1, 0)).to(ids.dtype)
    cnt = torch.clamp(cnt, 0, n_blocks).to(cnt.dtype)
    return ids, cnt
