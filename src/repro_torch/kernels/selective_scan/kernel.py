"""Mamba selective scan: kernel wrapper and its plain PyTorch version.

`selective_scan` computes the region of `repro.models.ssm.mamba_block`
from its `lax.scan` over time through the D skip and the SiLU(z) gate
(`repro/models/ssm.py:78-112`), the function of upstream Mamba's
`selective_scan_fn(u, delta, A, B, C, D, z)` with delta's softplus already
applied. The reference has no Pallas kernel here. On a CUDA tensor the
wrapper launches the hand-written kernel in
`repro_torch/kernels/csrc/selective_scan.cu` (`repro_selective_scan_f32`)
and counts the launch in `selective_scan.launches`; on a CPU tensor it runs
`selective_scan_plain`. There is no fallback from one to the other. The
kernel has no backward: under autograd on the card its launch site raises.

Operands: x, dt, z (B, S, di) in the activation type, b, c (B, S, N) and
a (di, N) float32, d (di,) in the activation type, h0 (B, di, N) float32.
The state is float32 throughout, as in the reference; the kernel takes
float32 activations only (the served path), the plain version also the
reference's bf16 training type, rounding where the reference rounds.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.cuda import check_scan_operands, launch_selective_scan


def selective_scan_plain(x, dt, a, b, c, d, z, h0):
    """The scan step by step in plain PyTorch -> (out (B, S, di) in x's
    type, h_last (B, di, N) float32): for each t,
    h = exp(dt_t * a) * h + (dt_t * x_t) * b_t, y_t = sum_n h * c_t; then
    out = (y + x * d) * silu(z). The reference's tensor ops in its order:
    dt * x in the activation type, widened; y rounded to the activation
    type before the skip and the gate."""
    check_scan_operands(x, dt, a, b, c, d, z, h0)
    h = h0
    ys = []
    for t in range(x.shape[1]):
        dtt = dt[:, t]
        da = torch.exp(dtt.float()[..., None] * a)
        h = da * h + (dtt * x[:, t]).float()[..., None] * b[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    y = torch.stack(ys, 1).to(x.dtype)
    y = y + x * d
    return y * F.silu(z), h


def selective_scan(x, dt, a, b, c, d, z, h0):
    """The selective scan with its skip and gate -> (out, h_last). CUDA
    tensor: the CUDA kernel (float32 operands; views with a contiguous last
    dim are read in place); CPU tensor: the plain version."""
    if x.device.type == "cpu":
        return selective_scan_plain(x, dt, a, b, c, d, z, h0)
    if x.device.type != "cuda":
        raise ValueError(f"selective_scan runs on cuda or cpu, got {x.device}")
    out = launch_selective_scan(x, dt, a, b, c, d, z, h0)
    selective_scan.launches += 1
    return out


selective_scan.launches = 0
