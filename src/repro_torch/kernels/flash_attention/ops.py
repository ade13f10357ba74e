"""Differentiable flash attention (GQA layout): the counterpart of the JAX
package's `flash_attention_p` and its `jax.custom_vjp`
(`repro/kernels/flash_attention/ops.py`).

`FlashAttentionFn` runs `flash_fwd` forward, keeps q, k, v, out, m and l,
and runs `flash_bwd` backward: on the card the CUDA forward kernel and the
two CUDA backward kernels, on the host their plain versions. It takes either
layout `flash_fwd` takes and returns the gradients in the inputs' layouts.

`MLAAttentionFn` does the same for MLA's absorbed attention (one latent kv
head under H query heads): `flash_fwd_mla` forward, `flash_bwd_mla`
backward (the MLA kernel and its two backward kernels on the card). The
reference differentiates its jnp `flash_attention` there instead.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (
    flash_bwd,
    flash_bwd_mla,
    flash_fwd,
    flash_fwd_mla,
    mla_delta,
)


class FlashAttentionFn(torch.autograd.Function):
    """apply(q, k, v, scale, causal, q_offset, kv_len) -> out in q's layout;
    differentiable in q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, q_offset, kv_len):
        out, m, l = flash_fwd(q, k, v, scale=scale, causal=causal, q_offset=q_offset,
                              kv_len=kv_len)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.kw = dict(scale=scale, causal=causal, q_offset=q_offset, kv_len=kv_len)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, m, l = ctx.saved_tensors
        if do.stride(-1) != 1:  # the kernels read the head dim contiguously
            do = do.contiguous()
        dq, dk, dv = flash_bwd(q, k, v, out, m, l, do, **ctx.kw)
        return dq, dk, dv, None, None, None, None


class MLAAttentionFn(torch.autograd.Function):
    """apply(q, c_kv, k_rope, scale, causal, q_offset, kv_len) -> out (B, Sq,
    H, r) in c_kv's type; differentiable in q (B, Sq, H, r + dr), c_kv (B,
    Sk, r) and k_rope (B, Sk, dr), each gradient in its input's type."""

    @staticmethod
    def forward(ctx, q, c_kv, k_rope, scale, causal, q_offset, kv_len):
        kw = dict(scale=scale, causal=causal, q_offset=q_offset, kv_len=kv_len)
        out, m, l = flash_fwd_mla(q, c_kv, k_rope, **kw)
        ctx.save_for_backward(q, c_kv, k_rope, out, m, l)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, do):
        q, c_kv, k_rope, out, m, l = ctx.saved_tensors
        dq, dc, dkr = flash_bwd_mla(q, c_kv, k_rope, do, m, l, mla_delta(do, out), **ctx.kw)
        return dq, dc, dkr, None, None, None, None


def flash_mha(q, k, v, *, causal=True, scale=None, q_offset=0, kv_len=None):
    """q (B,Sq,KV,G,D), k/v (B,Sk,KV,D) -> (B,Sq,KV,G,D), differentiable in
    q, k and v through `FlashAttentionFn`.

    The kernels read the model layout through strides, so neither q nor the
    keys are transposed; GQA groups share one read of each K/V tile."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    return FlashAttentionFn.apply(q, k, v, scale, causal, q_offset, kv_len)
