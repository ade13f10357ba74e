"""GQA self-attention over a KV cache, fp32 or int8 (counterpart of
`repro.models.attention`; MLA, cross-attention, the mesh head-padding branch
and the dry-run stand-in are not ported).

The attention region runs through the flash kernels. Without a cache (the
training path) it goes through `FlashAttentionFn`, whose backward is the
flash backward kernels. With a cache (prefill and decode, under
`torch.no_grad()`) an fp32 cache goes through `flash_fwd`, an int8 cache
straight through `flash_fwd_q8` with its scales (the reference dequantizes
the whole cache first, then attends; the q8 kernel forms the same fp32
products per tile). The kernels read the model's (B, S, KV, G, hd) queries
and the (B, S_max, KV, hd) cache in place.

Unlike the reference's functional update, the cache is written in place:
`gqa_attention` returns the same `KVCache` it was given.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.kernel import dequantize, flash_fwd, flash_fwd_q8
from repro_torch.kernels.flash_attention.ops import FlashAttentionFn
from repro_torch.models.layers import as_drawn, dense_init, ones_init, rms_norm, rope


def flash_attention(q, k, v, *, causal: bool, scale: float, q_offset=0,
                    kv_len=None, k_scale=None, v_scale=None):
    """q: (B,Sq,KV,G,D)  k, v: (B,Sk,KV,D) -> (B,Sq,KV,G,D), forward only.

    `q_offset` is the absolute position of q[0] (decode: the cache write pos);
    `kv_len` masks keys at index >= kv_len (unwritten cache tail). int8 k, v
    come with their (B,Sk,KV) scales and go to the q8 kernel."""
    if k.dtype == torch.int8:
        return flash_fwd_q8(q, k, v, k_scale, v_scale, scale=scale, causal=causal,
                            q_offset=q_offset, kv_len=kv_len)
    out, _, _ = flash_fwd(q, k, v, scale=scale, causal=causal, q_offset=q_offset,
                          kv_len=kv_len)
    return out


def init_gqa(generator: torch.Generator, cfg: ModelConfig, place=as_drawn) -> dict:
    """`place` takes each leaf as it is drawn."""
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    p = {"wq": place(dense_init(generator, (d, h, hd)))}
    p["wk"] = place(dense_init(generator, (d, kv, hd)))
    p["wv"] = place(dense_init(generator, (d, kv, hd)))
    p["wo"] = place(dense_init(generator, (h, hd, d), fan_in=h * hd))
    if cfg.qk_norm:
        p["q_norm"] = place(ones_init((hd,)))
        p["k_norm"] = place(ones_init((hd,)))
    return p


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, KV, hd) fp32, or int8 when quantized
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None  # (B, S_max, KV) per-token-head absmax
    v_scale: Optional[torch.Tensor] = None


def init_gqa_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device=None) -> KVCache:
    """dtype torch.int8 -> quantized cache with fp32 scales."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    if dtype == torch.int8:
        return KVCache(k=torch.zeros(shape, dtype=torch.int8, device=device),
                       v=torch.zeros(shape, dtype=torch.int8, device=device),
                       k_scale=torch.zeros(shape[:3], device=device),
                       v_scale=torch.zeros(shape[:3], device=device))
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _quantize_kv(x):
    """(B,S,KV,hd) -> int8 values + (B,S,KV) scales (symmetric absmax;
    round half to even, as jnp.round)."""
    x32 = x.float()
    scale = torch.clamp_min(x32.abs().amax(-1), 1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequantize_kv(q, scale, dtype):
    return dequantize(q, scale).to(dtype)


def gqa_attention(p, x, *, cfg: ModelConfig, positions, causal=True,
                  cache: Optional[KVCache] = None, write_pos=None):
    """x: (B,S,D). cache + write_pos: write k/v at write_pos (in place),
    attend over the whole cache. Returns (out, cache)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = q.reshape(b, s, kv, h // kv, hd)

    if cache is None:  # training: differentiable through the backward kernels
        out = FlashAttentionFn.apply(q, k, v, hd ** -0.5, causal, 0, None)
    else:
        wp, scales = int(write_pos), {}
        if cache.k.dtype == torch.int8:
            kq, ks = _quantize_kv(k)
            vq, vs = _quantize_kv(v)
            cache.k[:, wp:wp + s] = kq
            cache.v[:, wp:wp + s] = vq
            cache.k_scale[:, wp:wp + s] = ks
            cache.v_scale[:, wp:wp + s] = vs
            scales = {"k_scale": cache.k_scale, "v_scale": cache.v_scale}
        else:
            cache.k[:, wp:wp + s] = k.to(cache.k.dtype)
            cache.v[:, wp:wp + s] = v.to(cache.v.dtype)
        out = flash_attention(q, cache.k, cache.v, causal=causal, scale=hd ** -0.5,
                              q_offset=wp, kv_len=wp + s, **scales)
    out = out.reshape(b, s, h, hd)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(out.dtype))
    return out, cache
