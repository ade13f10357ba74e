"""Symmetric absmax int8 quantization (counterpart of `repro.quant.quantize`).

scale = absmax / 127, q = clip(round(x / scale), -127, 127): zero maps to
zero exactly, so every sparsity mechanism (ECR dead channel blocks, BSR
pruned weight blocks) still sees the same zeros and the schedules do not
change. `torch.round` rounds half to even, as `jnp.round` does, and the
division runs in fp32 as in the reference, so both packages quantize to the
same int8 values.

Granularity: activations get one scale per tensor (per sample when
batched), weights one scale per output channel.
"""
from __future__ import annotations

import torch

INT8_MAX = 127.0


def absmax_scale(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Symmetric scale(s): absmax / 127 over `axis` (None = whole tensor),
    floored at 1e-12 / 127 so an all-zero slice divides cleanly. (The
    reference's `keepdims=` has no caller and is not ported.)"""
    a = x.float().abs()
    m = a.amax() if axis is None else a.amax(dim=axis)
    return torch.clamp(m, min=1e-12) / INT8_MAX


def quantize_int8(x: torch.Tensor, scale) -> torch.Tensor:
    """clip(round(x / scale)) -> int8. `scale` broadcasts against x."""
    q = torch.round(x.float() / scale)
    return torch.clamp(q, -INT8_MAX, INT8_MAX).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale) -> torch.Tensor:
    return q.float() * scale


def quantize_weights(w: torch.Tensor):
    """(O,C,kh,kw) -> (wq int8, sw (O,) per-output-channel scales)."""
    sw = absmax_scale(w, axis=(1, 2, 3))
    return quantize_int8(w, sw[:, None, None, None]), sw


def quantize_acts(x: torch.Tensor, per_sample: bool = False):
    """x (C,H,W) or (N,C,H,W) -> (xq int8, sx scale): one scale per batch
    sample (shape (N,)) when per_sample, else one scalar."""
    if per_sample:
        sx = absmax_scale(x, axis=tuple(range(1, x.ndim)))
        return quantize_int8(x, sx.reshape((-1,) + (1,) * (x.ndim - 1))), sx
    sx = absmax_scale(x)
    return quantize_int8(x, sx), sx
