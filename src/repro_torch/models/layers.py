"""Shared LM layer primitives: norms, rotary and sinusoidal positions,
initializers (counterpart of `repro.models.layers`; parameters are plain
tensors, and each init function hands every leaf to its `place` callback
with the leaf's logical axes, where the reference wraps it in a `Px`).

The initializers draw from a `torch.Generator` on the generator's own device:
a host generator gives the same weights whatever device the caller moves them
to, a CUDA generator draws on the card. Given no generator they return
uninitialized tensors of the same shapes (the parameter count takes them on
the meta device)."""
from __future__ import annotations

import math
from typing import Optional

import torch


def as_drawn(t: torch.Tensor, axes: tuple = ()) -> torch.Tensor:
    """The initializers' default `place(leaf, axes)`: a drawn leaf stays as
    drawn, its logical axes unused."""
    return t


def dense_init(generator: torch.Generator, shape, fan_in: Optional[int] = None,
               dtype=torch.float32) -> torch.Tensor:
    """Normal, scaled by fan_in ** -0.5; fan_in defaults to shape[-2] (the
    reference's rule, so wq (d, h, hd) takes fan_in = h)."""
    if generator is None:
        return torch.empty(tuple(shape), dtype=dtype)
    fi = fan_in or (shape[-2] if len(shape) >= 2 else shape[-1])
    # scaled in place: an expert leaf of full-width arctic-480b is 17.85 GB
    return torch.randn(tuple(shape), generator=generator, device=generator.device,
                       dtype=dtype).mul_(fi ** -0.5)


def embed_init(generator: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    if generator is None:
        return torch.empty(tuple(shape), dtype=dtype)
    return torch.randn(tuple(shape), generator=generator, device=generator.device,
                       dtype=dtype).mul_(0.02)


def ones_init(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype)


def rms_norm(x, scale, eps=1e-5):
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope(x, positions, theta: float = 10_000.0):
    """x: (B, S, *H, d) rotated over its last dim in split halves (not
    interleaved); positions: (B, S) or (S,)."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"rope needs an even head dim, got {d}")
    freq = theta ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = positions.to(device=x.device, dtype=torch.float32)[..., None] * freq
    while ang.ndim < x.ndim:
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def sinusoid_positions(n: int, d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(n, d) sinusoidal positions of 0 .. n-1: sin in the even columns, cos in
    the odd ones (the whisper encoder's table)."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(-torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
                    * math.log(10_000.0))
    pe = torch.zeros((n, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)
