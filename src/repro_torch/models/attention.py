"""GQA self- and cross-attention and MLA self-attention over a cache
(counterpart of `repro.models.attention`; the mesh head-padding branch and
the dry-run stand-in are not ported).

GQA: the attention region runs through the flash kernels. Without a cache
(the training path) it goes through `FlashAttentionFn`, whose backward is
the flash backward kernels. With a cache (prefill and decode, under
`torch.no_grad()`) an fp32 cache goes through `flash_fwd`, an int8 cache
straight through `flash_fwd_q8` with its scales (the reference dequantizes
the whole cache first, then attends; the q8 kernel forms the same fp32
products per tile). The kernels read the model's (B, S, KV, G, hd) queries
and the (B, S_max, KV, hd) cache in place.

A cross-attention sublayer (llama-3.2-vision's image layers, whisper's
decoder) is GQA whose K and V are projected from `kv_src` (image
embeddings, or the encoder's output) instead of x: non-causal, without
rope, without a cache (its K / V are recomputed from `kv_src` at every
call, as the reference does), and its output scaled by tanh of the
sublayer's `gate`, an fp32 scalar drawn as 0.0. It runs through
`FlashAttentionFn` like the training path, so under `torch.no_grad()` too
a cross call launches `repro_flash_fwd_f32`, whatever the request's cache
type. Given no `kv_src` a cross sublayer attends over x itself, with rope
(the reference's fallback, `repro/models/attention.py:190, 196`).

MLA (deepseek-v2) keeps the reference's absorbed form: w_uk is folded into
the queries, so the cache holds only the latent `c_kv` (B, S, r) and the
shared rotary key `k_rope` (B, S, dr), and attention runs as one shared kv
head of key width r + dr and value width r over the H query heads
(`flash_fwd_mla`, the MLA kernel). The kernel reads a layer's view of the
stacked cache in place; the reference concatenates [c_kv ; k_rope] into
its keys on every step. An fp32 request gives an fp32 latent cache, an
int8 request a bf16 one (the reference's `init_group_caches`: latent
states are not quantized). Without a cache and with autograd recording (the
training path) it goes through `MLAAttentionFn`, whose backward is the MLA
backward kernels.

Unlike the reference's functional update, the cache is written in place:
both attentions return the cache they were given.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.kernel import (
    dequantize,
    flash_fwd,
    flash_fwd_mla,
    flash_fwd_q8,
)
from repro_torch.kernels.flash_attention.ops import FlashAttentionFn, MLAAttentionFn
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


def init_gqa(generator: torch.Generator, cfg: ModelConfig, place=as_drawn,
             cross: bool = False) -> dict:
    """`place` takes each leaf as it is drawn. A cross-attention sublayer
    adds `gate`, an fp32 scalar 0.0 (no draw): tanh(0) = 0, so a fresh cross
    sublayer adds nothing to the residual."""
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    p = {"wq": place(dense_init(generator, (d, h, hd)), ("embed", "heads", "head_dim"))}
    p["wk"] = place(dense_init(generator, (d, kv, hd)), ("embed", "kv_heads", "head_dim"))
    p["wv"] = place(dense_init(generator, (d, kv, hd)), ("embed", "kv_heads", "head_dim"))
    p["wo"] = place(dense_init(generator, (h, hd, d), fan_in=h * hd),
                    ("heads", "head_dim", "embed"))
    if cfg.qk_norm:
        p["q_norm"] = place(ones_init((hd,)), (None,))
        p["k_norm"] = place(ones_init((hd,)), (None,))
    if cross:
        p["gate"] = place(torch.zeros((), dtype=torch.float32), ())
    return p


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, KV, hd) fp32, or int8 when quantized
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None  # (B, S_max, KV) per-token-head absmax
    v_scale: Optional[torch.Tensor] = None


def cache_axes(quantized: bool) -> KVCache:
    """The cache's logical axes (the reference's `cache_axes`); the scale
    fields are None for an unquantized cache, as its tensors are."""
    sc = ("batch", "cache_seq", "cache_kv") if quantized else None
    return KVCache(k=("batch", "cache_seq", "cache_kv", "cache_hd"),
                   v=("batch", "cache_seq", "cache_kv", "cache_hd"),
                   k_scale=sc, v_scale=sc)


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
                  cache: Optional[KVCache] = None, write_pos=None,
                  kv_src: Optional[torch.Tensor] = None):
    """x: (B,S,D); kv_src: (B,Sk,D) image or encoder states for
    cross-attention (K and V come from it, no rope). cache + write_pos:
    write k/v at write_pos (in place), attend over the whole cache. A
    sublayer with a `gate` scales its output by tanh(gate). Returns (out,
    cache)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    src = x if kv_src is None else kv_src
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", src, p["wk"].to(src.dtype))
    v = torch.einsum("bsd,dhk->bshk", src, p["wv"].to(src.dtype))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_theta and kv_src is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = q.reshape(b, s, kv, h // kv, hd)

    if cache is None:  # training and cross-attention: no cache, no kv_len
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
    if "gate" in p:  # gated cross-attention (llama-vision style)
        out = torch.tanh(p["gate"].to(out.dtype)) * out
    return out, cache


# ---------------------------------------------------------------------------
# MLA block (deepseek-v2), absorbed formulation
# ---------------------------------------------------------------------------

def init_mla(generator: torch.Generator, cfg: ModelConfig, place=as_drawn) -> dict:
    """The reference's leaves, shapes and fan-ins; `place` takes each leaf
    as it is drawn."""
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
    return {
        "w_dq": place(dense_init(generator, (d, qr)), ("embed", "q_lora")),
        "w_uq": place(dense_init(generator, (qr, h, dn + dr)), ("q_lora", "heads", "head_dim")),
        "w_dkv": place(dense_init(generator, (d, r)), ("embed", "kv_lora")),
        "w_uk": place(dense_init(generator, (r, h, dn)), ("kv_lora", "heads", "head_dim")),
        "w_uv": place(dense_init(generator, (r, h, dv)), ("kv_lora", "heads", "head_dim")),
        "w_kr": place(dense_init(generator, (d, dr)), ("embed", "head_dim")),
        "w_o": place(dense_init(generator, (h, dv, d), fan_in=h * dv),
                     ("heads", "head_dim", "embed")),
        "q_norm": place(ones_init((qr,)), (None,)),
        "kv_norm": place(ones_init((r,)), (None,)),
    }


class MLACache(NamedTuple):
    c_kv: torch.Tensor  # (B, S_max, r) the compressed latent: keys and values
    k_rope: torch.Tensor  # (B, S_max, dr) the shared rotary key


MLA_CACHE_AXES = MLACache(c_kv=("batch", "cache_seq", None),
                          k_rope=("batch", "cache_seq", None))


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device=None) -> MLACache:
    """dtype float32 or bfloat16 (the reference's latent cache for an int8
    request)."""
    return MLACache(
        c_kv=torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
        k_rope=torch.zeros((batch, max_len, cfg.rope_head_dim), dtype=dtype, device=device))


def mla_attention(p, x, *, cfg: ModelConfig, positions, causal=True,
                  cache: Optional[MLACache] = None, write_pos=None):
    """x: (B,S,D). cache + write_pos: write c_kv / k_rope at write_pos (in
    place, in the cache's type), attend over the whole cache. Returns (out,
    cache). Without a cache, with autograd recording, differentiable through
    `MLAAttentionFn`."""
    b, s, _ = x.shape
    dn, dr = cfg.nope_head_dim, cfg.rope_head_dim
    cq = rms_norm(x @ p["w_dq"].to(x.dtype), p["q_norm"], cfg.norm_eps)
    q = torch.einsum("bsq,qhk->bshk", cq, p["w_uq"].to(x.dtype))
    q_nope, q_rope = q[..., :dn], rope(q[..., dn:], positions, cfg.rope_theta)
    # absorb w_uk: queries into the latent space, so the cache never
    # expands per head
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, p["w_uk"].to(x.dtype))
    c_kv = rms_norm(x @ p["w_dkv"].to(x.dtype), p["kv_norm"], cfg.norm_eps)
    k_rope = rope(x @ p["w_kr"].to(x.dtype), positions, cfg.rope_theta)

    kv_len, q_offset = None, 0
    if cache is not None:
        wp = int(write_pos)
        cache.c_kv[:, wp:wp + s] = c_kv.to(cache.c_kv.dtype)
        cache.k_rope[:, wp:wp + s] = k_rope.to(cache.k_rope.dtype)
        c_kv, k_rope = cache.c_kv, cache.k_rope
        kv_len, q_offset = wp + s, wp
    # one shared kv head: keys [c_kv ; k_rope], values c_kv, queries
    # [q_lat ; q_rope] over the H heads
    q_eff = torch.cat([q_lat, q_rope], dim=-1)  # (B, S, H, r + dr)
    scale = (dn + dr) ** -0.5
    if cache is None and torch.is_grad_enabled():  # training: no cache, no kv_len
        out_lat = MLAAttentionFn.apply(q_eff, c_kv, k_rope, scale, causal, 0, None)
    else:
        out_lat, _, _ = flash_fwd_mla(q_eff, c_kv, k_rope, scale=scale, causal=causal,
                                      q_offset=q_offset, kv_len=kv_len)
    out = torch.einsum("bshr,rhv->bshv", out_lat.to(x.dtype), p["w_uv"].to(x.dtype))
    out = torch.einsum("bshv,hvd->bsd", out, p["w_o"].to(x.dtype))
    return out, cache
