"""Mamba selective scan: kernel wrappers, their plain PyTorch versions and
the differentiable `SelectiveScanFn`.

`selective_scan` computes the region of `repro.models.ssm.mamba_block`
from its `lax.scan` over time through the D skip and the SiLU(z) gate
(`repro/models/ssm.py:78-112`), the function of upstream Mamba's
`selective_scan_fn(u, delta, A, B, C, D, z)` with delta's softplus already
applied; `selective_scan_bwd` its gradients, which the reference takes by
autodiff of that scan. The reference has no Pallas kernel here. On a CUDA
tensor each wrapper launches its hand-written kernel in
`repro_torch/kernels/csrc/selective_scan.cu` (`repro_selective_scan_f32` /
`_bf16`, `repro_selective_scan_bwd_f32` / `_bf16`) and counts the launch in
its `.launches`; on a CPU tensor it runs its plain version. There is no
fallback from one to the other. `SelectiveScanFn` runs the forward wrapper
forward and the backward wrapper backward, on either device.

Operands: x, dt, z (B, S, di) in the activation type (float32 or
bfloat16; float64 on the host), b, c (B, S, N) and a (di, N) float32, d
(di,) in the activation type, h0 (B, di, N) float32. The state is float32
throughout, as in the reference; the forward rounds where the reference
rounds for bf16 activations, and the backward computes every gradient in
float32 from those rounded values and rounds it once to its operand's type.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.cuda import (
    check_scan_operands,
    launch_selective_scan,
    launch_selective_scan_bwd,
)


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
        da = torch.exp(dtt.to(a.dtype)[..., None] * a)
        h = da * h + (dtt * x[:, t]).to(a.dtype)[..., None] * b[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    y = torch.stack(ys, 1).to(x.dtype)
    y = y + x * d
    return y * F.silu(z), h


def selective_scan(x, dt, a, b, c, d, z, h0):
    """The selective scan with its skip and gate -> (out, h_last). CUDA
    tensor: the CUDA kernel (float32 or bfloat16 activations; views with a
    contiguous last dim are read in place); CPU tensor: the plain version."""
    if x.device.type == "cpu":
        return selective_scan_plain(x, dt, a, b, c, d, z, h0)
    if x.device.type != "cuda":
        raise ValueError(f"selective_scan runs on cuda or cpu, got {x.device}")
    out = launch_selective_scan(x, dt, a, b, c, d, z, h0)
    selective_scan.launches += 1
    return out


selective_scan.launches = 0


def selective_scan_bwd_plain(x, dt, a, b, c, d, z, h0, dout, dh_last):
    """The scan's gradients in plain PyTorch -> (dx, ddt, da, db, dc, dd, dz,
    dh0), each in its operand's type, from dout (x's shape and type) and
    dh_last (h_last's). The states are recomputed with the forward's
    rounded u = dt * x; t1 = y + x * d and silu(z) are the forward's
    (rounded) values; every gradient is a float32 (float64 for float64)
    sum, walked back over time:
    dt1 = dout * silu(z), dz = dout * t1 * silu'(z), dd = sum dt1 * x,
    dh += dt1 * c_t, dc_t = sum_d dt1 * h_t, du = sum_n dh * b_t, db_t =
    sum_d dh * u_t, g = dh * h_{t-1} * exp(dt_t a), da += g * dt_t, ddt_t =
    sum_n g * a + du * x_t, dx_t = dt1 * d + du * dt_t, dh *= exp(dt_t a)."""
    check_scan_operands(x, dt, a, b, c, d, z, h0)
    wt = torch.promote_types(x.dtype, torch.float32)
    rnd = ((lambda v: v.to(x.dtype).to(wt)) if x.dtype == torch.bfloat16
           else (lambda v: v))
    xf, dtf, zf, df, gf = (t.to(wt) for t in (x, dt, z, d, dout))
    af, bf, cf = a.to(wt), b.to(wt), c.to(wt)
    u = rnd(dtf * xf)
    decay = torch.exp(dtf[..., None] * af)  # (B, S, di, N)
    h, hs = h0.to(wt), []
    for t in range(x.shape[1]):
        h = decay[:, t] * h + u[:, t, :, None] * bf[:, t, None, :]
        hs.append(h)
    hs = torch.stack(hs, 1)
    y = torch.einsum("bsdn,bsn->bsd", hs, cf)
    t1 = rnd(rnd(y) + rnd(xf * df))
    sig = torch.sigmoid(zf)
    dt1 = gf * rnd(F.silu(zf))
    dz = gf * t1 * sig * (1 + zf * (1 - sig))
    dd = (dt1 * xf).sum((0, 1))
    dc = torch.einsum("bsd,bsdn->bsn", dt1, hs)
    dx, ddt, db = dt1 * df, torch.empty_like(xf), torch.empty_like(bf)
    da = torch.zeros_like(af)
    dh = dh_last.to(wt)
    for t in reversed(range(x.shape[1])):
        dh = dh + dt1[:, t, :, None] * cf[:, t, None, :]
        du = torch.einsum("bdn,bn->bd", dh, bf[:, t])
        db[:, t] = torch.einsum("bdn,bd->bn", dh, u[:, t])
        g = dh * (hs[:, t - 1] if t > 0 else h0.to(wt)) * decay[:, t]
        da += (g * dtf[:, t, :, None]).sum(0)
        ddt[:, t] = (g * af).sum(-1) + du * xf[:, t]
        dx[:, t] += du * dtf[:, t]
        dh = dh * decay[:, t]
    return (dx.to(x.dtype), ddt.to(dt.dtype), da.to(a.dtype), db.to(b.dtype), dc.to(c.dtype),
            dd.to(d.dtype), dz.to(z.dtype), dh.to(h0.dtype))


def selective_scan_bwd(x, dt, a, b, c, d, z, h0, dout, dh_last):
    """The scan's gradients -> (dx, ddt, da, db, dc, dd, dz, dh0). CUDA
    tensor: the backward kernel, on contiguous copies; CPU tensor: the plain
    version."""
    if x.device.type == "cpu":
        return selective_scan_bwd_plain(x, dt, a, b, c, d, z, h0, dout, dh_last)
    if x.device.type != "cuda":
        raise ValueError(f"selective_scan_bwd runs on cuda or cpu, got {x.device}")
    grads = launch_selective_scan_bwd(*(t.contiguous() for t in
                                        (x, dt, a, b, c, d, z, h0, dout, dh_last)))
    selective_scan_bwd.launches += 1
    return grads


selective_scan_bwd.launches = 0


class SelectiveScanFn(torch.autograd.Function):
    """apply(x, dt, a, b, c, d, z, h0) -> (out, h_last), as `selective_scan`;
    differentiable in every operand through `selective_scan_bwd`."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, d, z, h0):
        out, h_last = selective_scan(x, dt, a, b, c, d, z, h0)
        ctx.save_for_backward(x, dt, a, b, c, d, z, h0)
        return out, h_last

    @staticmethod
    def backward(ctx, dout, dh_last):
        return selective_scan_bwd(*ctx.saved_tensors, dout, dh_last)
