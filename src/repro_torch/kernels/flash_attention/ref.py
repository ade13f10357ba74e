"""Oracle for the flash attention kernel: plain softmax attention in fp32."""
from __future__ import annotations

import torch

NEG = -1e30


def attention_ref(q, k, v, *, scale, causal, q_offset=0, kv_len=None):
    """q:(BKV,G,Sq,D) k,v:(BKV,Sk,D) -> (BKV,G,Sq,D), fp32 math, masked
    scores at -1e30 (not -inf: a fully masked row averages v)."""
    sq, sk = q.shape[2], k.shape[1]
    s = torch.einsum("bgqd,bkd->bgqk", q.float(), k.float()) * scale
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if kv_len is not None:
        mask &= (kpos < kv_len)[None, :]
    s = torch.where(mask, s, torch.full((), NEG, device=q.device))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)
    return torch.einsum("bgqk,bkd->bgqd", p, v.float()).to(q.dtype)
