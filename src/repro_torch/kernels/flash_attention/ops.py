"""Model-facing flash attention (GQA layout), forward only.

The JAX package wraps its Pallas kernels in a `jax.custom_vjp`; the port's
backward kernel comes with the training slice, and with it a
`torch.autograd.Function`. Until then this entry has no gradient, and the
port's LM runs under `torch.no_grad()`.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_fwd


def flash_mha(q, k, v, *, causal=True, scale=None, q_offset=0, kv_len=None):
    """q (B,Sq,KV,G,D), k/v (B,Sk,KV,D) -> (B,Sq,KV,G,D).

    The kernel reads the model layout through strides, so neither q nor the
    keys are transposed; GQA groups share one read of each K/V tile."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    out, _, _ = flash_fwd(q, k, v, scale=scale, causal=causal, q_offset=q_offset,
                          kv_len=kv_len)
    return out
