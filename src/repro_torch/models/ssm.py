"""Mamba (selective SSM) block, jamba's attention-free sublayer
(counterpart of `repro.models.ssm`; no sharding annotations).

The decode state is O(1) in the sequence: the causal conv's ring of the last
cw - 1 inputs and the (B, di, N) fp32 SSM state. The recurrence itself runs
through `kernels.selective_scan.selective_scan`: on the card one launch of
the hand-written scan kernel, which keeps each channel's state in registers
for the whole sequence (the reference's jnp `lax.scan`, unrolled so that
its state crosses device memory less often); on the host its plain version,
a loop over time of the reference's tensor ops. With autograd recording (the
training path) it goes through `SelectiveScanFn`, whose backward is the
scan's backward kernel on the card and its plain version on the host.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.selective_scan.kernel import SelectiveScanFn, selective_scan
from repro_torch.models.layers import as_drawn, dense_init, ones_init


def _d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def init_mamba(generator: torch.Generator, cfg: ModelConfig, place=as_drawn) -> dict:
    """The reference's leaves, shapes and fan-ins: a_log = log(1..N) on
    every channel, d_skip = 1; `place` takes each leaf as it is drawn."""
    d, di, n, cw = cfg.d_model, _d_inner(cfg), cfg.ssm_state_dim, cfg.ssm_conv_width
    dt_rank = max(1, d // 16)
    return {
        "in_proj": place(dense_init(generator, (d, 2 * di)), ("embed", "mlp")),
        "conv_w": place(dense_init(generator, (cw, di), fan_in=cw), (None, "mlp")),
        "x_proj": place(dense_init(generator, (di, dt_rank + 2 * n)), ("mlp", None)),
        "dt_proj": place(dense_init(generator, (dt_rank, di)), (None, "mlp")),
        "a_log": place(torch.log(torch.arange(1, n + 1, dtype=torch.float32)).repeat(di, 1),
                       ("mlp", None)),
        "d_skip": place(ones_init((di,)), ("mlp",)),
        "out_proj": place(dense_init(generator, (di, d), fan_in=di), ("mlp", "embed")),
    }


class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, cw-1, di) ring of the last inputs, fp32
    ssm: torch.Tensor  # (B, di, N) fp32


MAMBA_STATE_AXES = MambaState(conv=("batch", None, "mlp"), ssm=("batch", "mlp", None))


def init_mamba_state(cfg: ModelConfig, batch: int, device=None) -> MambaState:
    """Zeros, fp32 for every request. The reference makes an int8
    request's conv ring bfloat16 but replaces it after every call with the
    activation-typed `new_conv`, so its ring holds fp32 values from the
    first prefill on; the port's ring is written in place, so it is fp32
    from the start (zeros are the same in either, and fp32 holds bf16
    activations exactly)."""
    di, n, cw = _d_inner(cfg), cfg.ssm_state_dim, cfg.ssm_conv_width
    return MambaState(conv=torch.zeros((batch, cw - 1, di), dtype=torch.float32, device=device),
                      ssm=torch.zeros((batch, di, n), dtype=torch.float32, device=device))


def mamba_block(p, x, cfg: ModelConfig, state: Optional[MambaState] = None):
    """x: (B,S,D) -> (y, new_state); `state` carries the decode recurrence.
    The new state is returned, not written: the caller writes it into its
    cache."""
    b, s, d = x.shape
    di, n, cw = _d_inner(cfg), cfg.ssm_state_dim, cfg.ssm_conv_width
    dt_rank = max(1, d // 16)
    xz = x @ p["in_proj"].to(x.dtype)  # (B,S,2di)
    xs, z = xz[..., :di], xz[..., di:]

    # causal depthwise conv1d of width cw over [state ring ; xs]
    prev = (state.conv.to(xs.dtype) if state is not None
            else torch.zeros((b, cw - 1, di), dtype=xs.dtype, device=x.device))
    xpad = torch.cat([prev, xs], dim=1)  # (B, S+cw-1, di)
    conv_w = p["conv_w"].to(xs.dtype)
    xc = sum(xpad[:, i:i + s, :] * conv_w[i] for i in range(cw))
    xc = F.silu(xc)
    new_conv = xpad[:, s:s + cw - 1, :]

    proj = xc @ p["x_proj"].to(xs.dtype)  # (B,S,dt_rank+2n)
    dt_in = proj[..., :dt_rank] @ p["dt_proj"].to(xs.dtype)
    dt = torch.logaddexp(dt_in, torch.zeros((), dtype=dt_in.dtype, device=x.device))  # softplus
    bmat = proj[..., dt_rank:dt_rank + n].float()  # (B,S,n)
    cmat = proj[..., dt_rank + n:].float()
    # the exp in the parameters' type (bf16 when training at bf16), widened as
    # the reference's step widens it (`dtt.astype(f32)[..., None] * a`)
    a = (-torch.exp(p["a_log"])).float()  # (di, n)
    h0 = (state.ssm if state is not None
          else torch.zeros((b, di, n), dtype=torch.float32, device=x.device))
    scan = SelectiveScanFn.apply if torch.is_grad_enabled() else selective_scan
    y, h_last = scan(xc, dt, a, bmat, cmat, p["d_skip"].to(x.dtype), z, h0)
    out = y @ p["out_proj"].to(x.dtype)
    return out, MambaState(conv=new_conv, ssm=h_last)
