"""Flash attention forward kernel wrappers and their plain PyTorch versions.

`flash_fwd` replaces `repro.kernels.flash_attention.kernel.flash_fwd_pallas`
and `flash_fwd_q8` replaces `flash_fwd_q8_pallas`. On a CUDA tensor each
launches the hand-written kernel in
`repro_torch/kernels/csrc/flash_attention.cu` and counts the launch in its
`.launches`; on a CPU tensor it runs its plain version. There is no fallback
from one to the other.

Both take the Pallas kernels' layout, q (BKV, G, Sq, D) with k, v (BKV, Sk, D),
or the model's, q (B, Sq, KV, G, D) with k, v (B, Sk, KV, D) read in place
(the KV cache needs no transpose), and return out in q's layout. m and l are
(BKV, G, Sq) in both, with bkv = b * KV + h. Unlike the Pallas wrappers there
are no `qc`/`kc` tile sizes: the kernel picks its own tiles and masks ragged
edges itself, for any Sq and Sk.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cuda import check_flash_operands, launch_flash

NEG = -1e30


def _kernel_layout(q, k, v, k_scale=None, v_scale=None):
    """Model layout -> the (BKV, ...) layout of the Pallas kernels (views)."""
    if q.ndim == 4:
        return q, k, v, k_scale, v_scale
    b, sq, kvh, g, d = q.shape
    sk = k.shape[1]
    qk = q.permute(0, 2, 3, 1, 4).reshape(b * kvh, g, sq, d)
    kk = k.permute(0, 2, 1, 3).reshape(b * kvh, sk, d)
    vk = v.permute(0, 2, 1, 3).reshape(b * kvh, sk, d)
    if k_scale is not None:
        k_scale = k_scale.permute(0, 2, 1).reshape(b * kvh, sk)
        v_scale = v_scale.permute(0, 2, 1).reshape(b * kvh, sk)
    return qk, kk, vk, k_scale, v_scale


def _model_layout(out, q):
    """(BKV, G, Sq, D) -> q's model layout (B, Sq, KV, G, D)."""
    if q.ndim == 4:
        return out
    b, sq, kvh, g, d = q.shape
    return out.reshape(b, kvh, g, sq, d).permute(0, 3, 1, 2, 4).contiguous()


def _plain_softmax(q, k, v, *, scale, causal, q_offset, kv_len):
    """The kernels' function in the (BKV, ...) layout: scores from the
    pre-scaled q, masked at -1e30, then (out, m, max(l, 1e-30))."""
    sq, sk = q.shape[2], k.shape[1]
    s = torch.einsum("bgqd,bkd->bgqk", q.float() * scale, k.float())
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if kv_len is not None:
        mask &= (kpos < kv_len)[None, :]
    s = torch.where(mask, s, torch.full((), NEG, device=q.device))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = torch.clamp_min(p.sum(-1), 1e-30)
    out = torch.einsum("bgqk,bkd->bgqd", p, v.float()) / l[..., None]
    return out, m, l


def flash_fwd_plain(q, k, v, *, scale, causal, q_offset=0, kv_len=None):
    """The fp32 kernel's function in plain PyTorch -> (out, m, l)."""
    check_flash_operands(q, k, v)
    qk, kk, vk, _, _ = _kernel_layout(q, k, v)
    out, m, l = _plain_softmax(qk, kk, vk, scale=scale, causal=causal,
                               q_offset=q_offset, kv_len=kv_len)
    return _model_layout(out, q).to(q.dtype), m, l


def flash_fwd(q, k, v, *, scale, causal, q_offset=0, kv_len=None):
    """GQA flash attention forward -> (out, m, l): out in q's layout, m and l
    (BKV, G, Sq) fp32. CUDA tensor: the CUDA kernel; CPU tensor: the plain
    version."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale=scale, causal=causal,
                               q_offset=q_offset, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu, got {q.device}")
    out = launch_flash(q, k, v, scale=scale, causal=causal, q_offset=q_offset,
                       kv_len=kv_len)
    flash_fwd.launches += 1
    return out


flash_fwd.launches = 0


def dequantize(x_q8, scale):
    """int8 K/V times its per-position scale, at fp32 (`_dequantize_kv`'s
    product)."""
    return x_q8.float() * scale[..., None]


def flash_fwd_q8_plain(q, k_q8, v_q8, k_scale, v_scale, *, scale, causal,
                       q_offset=0, kv_len=None):
    """The int8 kernel's function in plain PyTorch: dequantize, then the fp32
    kernel's function -> out."""
    check_flash_operands(q, k_q8, v_q8, k_scale, v_scale)
    qk, kk, vk, ks, vs = _kernel_layout(q, k_q8, v_q8, k_scale, v_scale)
    out, _, _ = _plain_softmax(qk, dequantize(kk, ks), dequantize(vk, vs),
                               scale=scale, causal=causal, q_offset=q_offset,
                               kv_len=kv_len)
    return _model_layout(out, q).to(q.dtype)


def flash_fwd_q8(q, k_q8, v_q8, k_scale, v_scale, *, scale, causal, q_offset=0,
                 kv_len=None):
    """Flash attention forward over an int8 K/V cache with fp32 per-position
    scales ((BKV, Sk) or (B, Sk, KV)), dequantized in the kernel -> out in q's
    layout. CUDA tensor: the CUDA kernel; CPU tensor: the plain version."""
    if q.device.type == "cpu":
        return flash_fwd_q8_plain(q, k_q8, v_q8, k_scale, v_scale, scale=scale,
                                  causal=causal, q_offset=q_offset, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd_q8 runs on cuda or cpu, got {q.device}")
    out = launch_flash(q, k_q8, v_q8, scale=scale, causal=causal,
                       q_offset=q_offset, kv_len=kv_len, k_scale=k_scale,
                       v_scale=v_scale)
    flash_fwd_q8.launches += 1
    return out


flash_fwd_q8.launches = 0
