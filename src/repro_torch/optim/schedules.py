"""LR schedules (counterpart of `repro.optim.schedules`): functions of the
step, computed in float32 as the reference computes them."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr, warmup_steps, total_steps, min_frac=0.1):
    """Linear warm-up to `peak_lr`, then a cosine down to `min_frac * peak_lr`
    at `total_steps`. `step` is an int or a tensor; returns a float32 scalar
    tensor (on the step's device)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * s / max(warmup_steps, 1)
    prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup_steps, warm, cos)
