"""Flash attention kernel wrappers and their plain PyTorch versions.

`flash_fwd` replaces `repro.kernels.flash_attention.kernel.flash_fwd_pallas`
and `flash_fwd_q8` replaces `flash_fwd_q8_pallas` (kernels in
`repro_torch/kernels/csrc/flash_attention.cu`); `flash_bwd` replaces
`flash_bwd_pallas` through its two passes, `flash_bwd_dq` (the `_dq_kernel`
call) and `flash_bwd_dkv` (the `_dkv_kernel` call), kernels in
`csrc/flash_attention_bwd.cu`. `flash_fwd_mla` computes `flash_fwd_pallas`'s
function at MLA's shape (key width r + dr, value width r, one kv head under
H query heads), which the reference runs as its chunked jnp
`flash_attention` (`repro/models/attention.py:336`) because the Pallas
kernel takes no Dk != Dv (kernel in `csrc/flash_mla.cu`), and
`flash_bwd_mla` its gradients, which the reference takes by autodiff of
that jnp code (kernels in `csrc/flash_mla_bwd.cu`). On a CUDA tensor
each wrapper launches its hand-written kernel and counts the launch in its
`.launches`; on a CPU tensor it runs its plain version. There is no
fallback from one to the other.

All take the Pallas kernels' layout, q (BKV, G, Sq, D) with k, v (BKV, Sk, D),
or the model's, q (B, Sq, KV, G, D) with k, v (B, Sk, KV, D) read in place
(the KV cache needs no transpose), and return out in q's layout. m and l are
(BKV, G, Sq) in both, with bkv = b * KV + h. Unlike the Pallas wrappers there
are no `qc`/`kc` tile sizes: the kernel picks its own tiles and masks ragged
edges itself, for any Sq and Sk.

Operand types: q, k, v (and do) all float32, or all bfloat16 (the training
path at the reference's default type; the bf16 kernels are
`repro_flash_fwd_bf16`, `repro_flash_bwd_dq_bf16` and
`repro_flash_bwd_dkv_bf16`), or float64 on the host (the gradient checks).
The plain versions compute in float32 (float64 for float64) and, for bf16
operands, round exactly where the Pallas kernels round:
- q * scale: the Python scale is first rounded to bf16 (JAX converts a
  weakly typed scalar to the array's type), and the product of two bf16
  values (exact in fp32) enters the scores unrounded, as the Pallas kernels
  compute it (interpret mode; rounding it to bf16 instead moves m and l by
  about 1e-3 relative);
- forward: p rounded to bf16 before P.V, out rounded to bf16; s, m and l
  fp32;
- dq pass: ds rounded to bf16 before ds.K, then times scale (fp32) and
  rounded;
- dk/dv pass: dk = bf16(ds)^T . (bf16(scale) q) and dv = p^T . do with p in
  fp32 (the reference widens do first, so `p.astype(do.dtype)` keeps fp32),
  each rounded to bf16 at the end.
Every other product is a float32 sum of exact products of bf16 values.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cuda import (
    check_flash_operands,
    check_mla_operands,
    launch_flash,
    launch_flash_bwd,
    launch_flash_mla,
    launch_flash_mla_bwd,
)

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


def _wide(x):
    """x in float32, or wider when it already is (float64 stays float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _rounded(x, dtype):
    """x (float32) rounded to bfloat16 and widened again when `dtype` is
    bfloat16 (the Pallas kernels' `.astype(k.dtype)`); else x itself."""
    return x.to(torch.bfloat16).to(x.dtype) if dtype == torch.bfloat16 else x


def _bf16_scale(scale: float) -> float:
    """The softmax scale as the Pallas kernels multiply a bf16 q by it: the
    Python float rounded to bfloat16."""
    return float(torch.tensor(float(scale), dtype=torch.float64).to(torch.bfloat16))


def _prescaled(q, scale):
    """q * scale as the Pallas kernels form it, widened: for bf16 q the exact
    product of q and bf16(scale) (16 significant bits, kept in fp32: the
    product feeds the fp32 dot unrounded), the plain product otherwise."""
    if q.dtype == torch.bfloat16:
        return q.float() * _bf16_scale(scale)
    return _wide(q) * scale


def _mask(sq, sk, causal, q_offset, kv_len, device):
    """(Sq, Sk) True where a query position sees a key."""
    qpos = q_offset + torch.arange(sq, device=device)
    kpos = torch.arange(sk, device=device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if kv_len is not None:
        mask &= (kpos < kv_len)[None, :]
    return mask


def _scores(q, k, *, scale, causal, q_offset, kv_len):
    """Scores from the pre-scaled q in the (BKV, ...) layout, masked at -1e30."""
    s = torch.einsum("bgqd,bkd->bgqk", _prescaled(q, scale), _wide(k))
    mask = _mask(q.shape[2], k.shape[1], causal, q_offset, kv_len, q.device)
    return torch.where(mask, s, torch.full((), NEG, dtype=s.dtype, device=q.device))


def _plain_softmax(q, k, v, *, scale, causal, q_offset, kv_len):
    """The kernels' function in the (BKV, ...) layout: scores from the
    pre-scaled q, masked at -1e30, then (out, m, max(l, 1e-30)); p enters
    P.V in v's type (l sums it unrounded)."""
    s = _scores(q, k, scale=scale, causal=causal, q_offset=q_offset, kv_len=kv_len)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = torch.clamp_min(p.sum(-1), 1e-30)
    out = torch.einsum("bgqk,bkd->bgqd", _rounded(p, v.dtype), _wide(v)) / l[..., None]
    return out, m, l


def flash_fwd_plain(q, k, v, *, scale, causal, q_offset=0, kv_len=None):
    """The fp32 and bf16 kernels' function in plain PyTorch -> (out in q's
    type, m, l fp32)."""
    check_flash_operands(q, k, v)
    qk, kk, vk, _, _ = _kernel_layout(q, k, v)
    out, m, l = _plain_softmax(qk, kk, vk, scale=scale, causal=causal,
                               q_offset=q_offset, kv_len=kv_len)
    return _model_layout(out, q).to(q.dtype), m, l


def flash_fwd(q, k, v, *, scale, causal, q_offset=0, kv_len=None):
    """GQA flash attention forward -> (out, m, l): out in q's layout and type,
    m and l (BKV, G, Sq) fp32. CUDA tensor: the CUDA kernel
    (`repro_flash_fwd_f32` or `repro_flash_fwd_bf16`); CPU tensor: the plain
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


# ---------------------------------------------------------------------------
# MLA: one latent kv head, keys [c_kv ; k_rope], values c_kv
# ---------------------------------------------------------------------------


def _mla_prescaled(q, scale):
    """q * scale as the reference's jnp `flash_attention` forms it
    (`q = q * scale`, repro/models/attention.py:61), widened: for a bf16 q
    the product with bf16(scale) rounded to bf16 (a weakly typed scalar
    takes the array's type, and so does the product: PyTorch multiplies a
    bf16 tensor by a Python float in fp32, where this product is exact, and
    rounds it once), else the product in q's (wide) type."""
    if q.dtype == torch.bfloat16:
        return (q * _bf16_scale(scale)).float()
    return _wide(q) * scale


def _mla_dscale(q, scale) -> float:
    """What the gradient of q * scale is multiplied by to give dq."""
    return _bf16_scale(scale) if q.dtype == torch.bfloat16 else scale


def flash_fwd_mla_plain(q, c_kv, k_rope, *, scale, causal, q_offset=0, kv_len=None):
    """The MLA kernels' function in plain PyTorch: q (B, Sq, H, r + dr) over
    keys [c_kv ; k_rope] (B, Sk, r + dr) and values c_kv (B, Sk, r) ->
    (out (B, Sq, H, r) in c_kv's type, m, l (B, Sq * H) fp32, row s * H + h).
    Scores are fp32 sums of q * scale (`_mla_prescaled`: rounded to bf16
    for a bf16 q) times the (widened) keys; over a bf16 latent p is rounded
    to bf16 before P.V and out once at the end, as the reference's
    `flash_attention` rounds (`p.astype(v.dtype)`, `out.astype(v.dtype)`).
    float64 operands compute in float64."""
    b, sq, h, _, _, _ = check_mla_operands(q, c_kv, k_rope)
    out, m, l = _plain_softmax(_mla_prescaled(q, scale).permute(0, 2, 1, 3),
                               torch.cat([c_kv, k_rope], dim=-1), c_kv, scale=1.0,
                               causal=causal, q_offset=q_offset, kv_len=kv_len)
    rows = (b, sq * h)
    return (out.permute(0, 2, 1, 3).contiguous().to(c_kv.dtype),
            m.permute(0, 2, 1).reshape(rows), l.permute(0, 2, 1).reshape(rows))


def flash_fwd_mla(q, c_kv, k_rope, *, scale, causal, q_offset=0, kv_len=None):
    """MLA flash attention forward, one latent kv head under the H query
    heads -> (out (B, Sq, H, r) in c_kv's type, m, l (B, Sq * H) fp32).
    q float32 over float32 latents (`repro_flash_fwd_mla_f32`) or over a
    bfloat16 latent (`repro_flash_fwd_mla_bf16kv`); a bfloat16 q over a
    bfloat16 latent (training at bf16) enters the bf16 latent's kernel as
    `_mla_prescaled(q, scale)` with scale 1, which rounds where the
    reference rounds (the kernel reads that fp32 q: twice a bf16 q's bytes).
    CUDA tensor: the CUDA kernel, reading c_kv and k_rope (a layer's view of
    the stacked cache) in place; CPU tensor: the plain version."""
    kw = dict(scale=scale, causal=causal, q_offset=q_offset, kv_len=kv_len)
    if not _on_card(q, "flash_fwd_mla"):
        return flash_fwd_mla_plain(q, c_kv, k_rope, **kw)
    if q.dtype == torch.bfloat16:
        check_mla_operands(q, c_kv, k_rope)
        q, kw["scale"] = _mla_prescaled(q, scale), 1.0
    out = launch_flash_mla(q, c_kv, k_rope, **kw)
    flash_fwd_mla.launches += 1
    return out


flash_fwd_mla.launches = 0


def mla_delta(do, out):
    """delta = rowsum(do * out) over the value width, (B, Sq * H) in float32
    (float64 for float64), contiguous."""
    dl = (_wide(do) * _wide(out)).sum(-1)
    return dl.reshape(dl.shape[0], -1).contiguous()


def flash_bwd_mla_plain(q, c_kv, k_rope, do, m, l, delta, *, scale, causal, q_offset=0,
                        kv_len=None, part=None):
    """The MLA backward kernels' function in plain PyTorch -> (dq, dc_kv,
    dk_rope), each in its input's type (part "dq": dq; "dkv": (dc_kv,
    dk_rope)). From qs = `_mla_prescaled(q, scale)` and the forward's m, l:
    p = exp(s - m) / l over the scores s = qs . [c_kv ; k_rope] (-1e30 where
    masked), dp = do . c_kv, ds = p * (dp - delta), 0 where masked (the
    reference's `where` passes no gradient to a masked score);
    dq = dscale * ds . K, dc_kv = ds^T qs[:r] + p^T do, dk_rope = ds^T
    qs[r:]. Sums in float32 (float64 for float64), each result rounded to
    its type once."""
    b, sq, h, sk, r, _ = check_mla_operands(q, c_kv, k_rope)
    qs = _mla_prescaled(q, scale)
    keys = _wide(torch.cat([c_kv, k_rope], dim=-1))
    mask = _mask(sq, sk, causal, q_offset, kv_len, q.device)[None, :, None, :]
    s = torch.einsum("bqhd,bkd->bqhk", qs, keys)
    s = torch.where(mask, s, torch.full((), NEG, dtype=s.dtype, device=q.device))
    stat = (b, sq, h, 1)
    p = torch.exp(s - m.reshape(stat)) / torch.clamp_min(l.reshape(stat), 1e-30)
    dow = _wide(do)
    dp = torch.einsum("bqhr,bkr->bqhk", dow, keys[..., :r])
    ds = torch.where(mask, p * (dp - delta.reshape(stat)), torch.zeros((), dtype=p.dtype,
                                                                      device=q.device))
    dq = torch.einsum("bqhk,bkd->bqhd", ds, keys) * _mla_dscale(q, scale)
    dq = dq.to(q.dtype)
    if part == "dq":
        return dq
    dkeys = torch.einsum("bqhk,bqhd->bkd", ds, qs)
    dc = (dkeys[..., :r] + torch.einsum("bqhk,bqhr->bkr", p, dow)).to(c_kv.dtype)
    dkr = dkeys[..., r:].contiguous().to(k_rope.dtype)
    return (dc, dkr) if part == "dkv" else (dq, dc, dkr)


def flash_bwd_mla(q, c_kv, k_rope, do, m, l, delta, *, scale, causal, q_offset=0,
                  kv_len=None, part=None):
    """MLA flash attention backward -> (dq, dc_kv, dk_rope) in the inputs'
    types, from the forward's m, l and delta = `mla_delta(do, out)` (part
    "dq" or "dkv": that pass alone). CUDA tensor: the dq kernel
    (`repro_flash_bwd_mla_dq_f32` / `_bf16`) and the dkv kernel
    (`repro_flash_bwd_mla_dkv_f32` / `_bf16`) on contiguous copies, a bf16 q
    entering them as `_mla_prescaled(q, scale)` with scale 1; `.launches`
    counts the calls. CPU tensor: the plain version."""
    kw = dict(scale=scale, causal=causal, q_offset=q_offset, kv_len=kv_len)
    if not _on_card(q, "flash_bwd_mla"):
        return flash_bwd_mla_plain(q, c_kv, k_rope, do, m, l, delta, part=part, **kw)
    check_mla_operands(q, c_kv, k_rope)
    dscale = _mla_dscale(q, scale)
    if q.dtype == torch.bfloat16:
        q, kw["scale"] = _mla_prescaled(q, scale), 1.0
    ops = tuple(t.contiguous() for t in (q, c_kv, k_rope, do, m, l, delta))
    dq = launch_flash_mla_bwd(*ops, part="dq", dscale=dscale, **kw) if part != "dkv" else None
    dkv = launch_flash_mla_bwd(*ops, part="dkv", **kw) if part != "dq" else None
    flash_bwd_mla.launches += 1
    return dq if part == "dq" else dkv if part == "dkv" else (dq, *dkv)


flash_bwd_mla.launches = 0


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


# ---------------------------------------------------------------------------
# backward: the dq pass and the dk/dv pass
# ---------------------------------------------------------------------------


def flash_delta(do, out):
    """delta = rowsum(do * out), (BKV, G, Sq), contiguous: the reference forms
    it outside its kernels (`flash_bwd_pallas`, kernel.py:263), and so does
    the port."""
    dl = (_wide(do) * _wide(out)).sum(-1)
    if do.ndim == 5:  # (B, Sq, KV, G) -> (B*KV, G, Sq)
        b, sq, kvh, g = dl.shape
        dl = dl.permute(0, 2, 3, 1).reshape(b * kvh, g, sq)
    return dl.contiguous()


def _plain_bwd(q, k, v, do, m, l, delta, *, scale, causal, q_offset, kv_len):
    """The backward kernels' function in plain PyTorch, any layout ->
    (dq, dk, dv) in the operands' layouts: p recomputed from the pre-scaled
    q and (m, l), ds = p * (dp - delta), dq = scale * ds k, dk = ds^T
    (scale q), dv = p^T do; for bf16, ds enters both products rounded to
    bf16 and p enters dv in fp32."""
    check_flash_operands(q, k, v)
    qk, kk, vk, _, _ = _kernel_layout(q, k, v)
    dok = _kernel_layout(do, k, v)[0]
    s = _scores(qk, kk, scale=scale, causal=causal, q_offset=q_offset, kv_len=kv_len)
    p = torch.exp(s - m[..., None]) / torch.clamp_min(l, 1e-30)[..., None]
    dok = _wide(dok)
    dp = torch.einsum("bgqd,bkd->bgqk", dok, _wide(vk))
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bgqk,bkd->bgqd", _rounded(ds, k.dtype), _wide(kk)) * scale
    dk = torch.einsum("bgqk,bgqd->bkd", _rounded(ds, q.dtype), _prescaled(qk, scale))
    dv = torch.einsum("bgqk,bgqd->bkd", p, dok)
    if q.ndim == 5:
        b, sk, kvh, d = k.shape
        dk = dk.reshape(b, kvh, sk, d).permute(0, 2, 1, 3)
        dv = dv.reshape(b, kvh, sk, d).permute(0, 2, 1, 3)
    return (_model_layout(dq, q).to(q.dtype), dk.contiguous().to(k.dtype),
            dv.contiguous().to(v.dtype))


def flash_bwd_dq_plain(q, k, v, do, m, l, delta, *, scale, causal, q_offset=0,
                       kv_len=None):
    """The dq kernel's function in plain PyTorch -> dq in q's layout."""
    return _plain_bwd(q, k, v, do, m, l, delta, scale=scale, causal=causal,
                      q_offset=q_offset, kv_len=kv_len)[0]


def flash_bwd_dkv_plain(q, k, v, do, m, l, delta, *, scale, causal, q_offset=0,
                        kv_len=None):
    """The dk/dv kernel's function in plain PyTorch -> (dk, dv) in k's layout."""
    return _plain_bwd(q, k, v, do, m, l, delta, scale=scale, causal=causal,
                      q_offset=q_offset, kv_len=kv_len)[1:]


def _on_card(q, name: str) -> bool:
    """True on a CUDA tensor, False on a CPU one; raises elsewhere."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, got {q.device}")
    return q.device.type == "cuda"


def flash_bwd_dq(q, k, v, do, m, l, delta, *, scale, causal, q_offset=0,
                 kv_len=None):
    """The dq pass (`flash_bwd_pallas`'s first call) -> dq in q's layout and
    type. CUDA tensor: `repro_flash_bwd_dq_f32` or `repro_flash_bwd_dq_bf16`;
    CPU tensor: the plain version."""
    kw = dict(scale=scale, causal=causal, q_offset=q_offset, kv_len=kv_len)
    if not _on_card(q, "flash_bwd_dq"):
        return flash_bwd_dq_plain(q, k, v, do, m, l, delta, **kw)
    dq = launch_flash_bwd(q, k, v, do, m, l, delta, part="dq", **kw)
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, m, l, delta, *, scale, causal, q_offset=0,
                  kv_len=None):
    """The dk/dv pass (`flash_bwd_pallas`'s second call) -> (dk, dv) in k's
    layout and type. CUDA tensor: `repro_flash_bwd_dkv_f32` or
    `repro_flash_bwd_dkv_bf16`; CPU tensor: the plain version."""
    kw = dict(scale=scale, causal=causal, q_offset=q_offset, kv_len=kv_len)
    if not _on_card(q, "flash_bwd_dkv"):
        return flash_bwd_dkv_plain(q, k, v, do, m, l, delta, **kw)
    dk, dv = launch_flash_bwd(q, k, v, do, m, l, delta, part="dkv", **kw)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_bwd_plain(q, k, v, out, m, l, do, *, scale, causal, q_offset=0,
                    kv_len=None):
    """`flash_bwd`'s function in plain PyTorch -> (dq, dk, dv)."""
    return _plain_bwd(q, k, v, do, m, l, flash_delta(do, out), scale=scale,
                      causal=causal, q_offset=q_offset, kv_len=kv_len)


def flash_bwd(q, k, v, out, m, l, do, *, scale, causal, q_offset=0, kv_len=None):
    """GQA flash attention backward -> (dq, dk, dv) in the operands' layouts,
    from the forward's out, m and l and the output gradient do (q's layout).
    CUDA tensor: delta = rowsum(do * out), then the dq and the dk/dv kernels
    (`.launches` counts these pairs); CPU tensor: the plain version."""
    kw = dict(scale=scale, causal=causal, q_offset=q_offset, kv_len=kv_len)
    if not _on_card(q, "flash_bwd"):
        return flash_bwd_plain(q, k, v, out, m, l, do, **kw)
    delta = flash_delta(do, out)
    dq = flash_bwd_dq(q, k, v, do, m, l, delta, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, do, m, l, delta, **kw)
    flash_bwd.launches += 1
    return dq, dk, dv


flash_bwd.launches = 0
