"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM (scalar
memory) (counterpart of `repro.models.xlstm`; no sharding annotations).

The xlstm-125m stack alternates mLSTM and sLSTM. Both gate exponentially
with the max-stabiliser, and their recurrences run in fp32: the
reference's `lax.scan`s over time are Python loops over time here, plain
PyTorch (no kernel: ROADMAP queue 2 lists the mLSTM chunk and the sLSTM
step as later kernel candidates). The decode state is O(1): (C, n, m) for
the mLSTM, (c, n, h, m) for the sLSTM.

d_ff = 0 in the config: the mLSTM block carries a pre-up-projection
(expand 2) and the sLSTM block a gated 4/3 FFN, as in the paper.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import as_drawn, dense_init, ones_init, rms_norm

NEG_STATE = -1e30  # the stabiliser's start: no step seen yet


def _di(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(generator: torch.Generator, cfg: ModelConfig, place=as_drawn) -> dict:
    """The reference's leaves, shapes and fan-ins (wq, wk, wv (di, H, dh)
    at fan-in H, the reference's rule for a 3-d leaf)."""
    d, di, h = cfg.d_model, _di(cfg), cfg.n_heads
    dh = di // h
    return {
        "up": place(dense_init(generator, (d, 2 * di)), ("embed", "mlp")),
        "wq": place(dense_init(generator, (di, h, dh)), ("mlp", "heads", "head_dim")),
        "wk": place(dense_init(generator, (di, h, dh)), ("mlp", "heads", "head_dim")),
        "wv": place(dense_init(generator, (di, h, dh)), ("mlp", "heads", "head_dim")),
        "wi": place(dense_init(generator, (di, h)), ("mlp", "heads")),
        "wf": place(dense_init(generator, (di, h)), ("mlp", "heads")),
        "down": place(dense_init(generator, (di, d), fan_in=di), ("mlp", "embed")),
    }


class MLSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, dh, dh) matrix memory
    n: torch.Tensor  # (B, H, dh)
    m: torch.Tensor  # (B, H) stabiliser


MLSTM_STATE_AXES = MLSTMState(c=("batch", "heads", None, None),
                              n=("batch", "heads", None), m=("batch", "heads"))


def init_mlstm_state(cfg: ModelConfig, batch: int, device=None) -> MLSTMState:
    h, dh = cfg.n_heads, _di(cfg) // cfg.n_heads
    return MLSTMState(
        c=torch.zeros((batch, h, dh, dh), dtype=torch.float32, device=device),
        n=torch.zeros((batch, h, dh), dtype=torch.float32, device=device),
        m=torch.full((batch, h), NEG_STATE, dtype=torch.float32, device=device))


def mlstm_block(p, x, cfg: ModelConfig, state: Optional[MLSTMState] = None,
                chunk: int = 128):
    """x: (B,S,D) -> (y, new_state). The chunkwise form when S > 1 and
    `chunk` divides S (the reference's rule; chunk 128 is its measured
    optimum), the sequential one otherwise (decode among them)."""
    b, s, _ = x.shape
    di, h = _di(cfg), cfg.n_heads
    dh = di // h
    up = x @ p["up"].to(x.dtype)
    xi, z = up[..., :di], up[..., di:]  # (B,S,di) each
    q = torch.einsum("bsd,dhk->bshk", xi, p["wq"].to(x.dtype)) * dh ** -0.5
    k = torch.einsum("bsd,dhk->bshk", xi, p["wk"].to(x.dtype)) * dh ** -0.5
    v = torch.einsum("bsd,dhk->bshk", xi, p["wv"].to(x.dtype))
    ig = torch.einsum("bsd,dh->bsh", xi, p["wi"].to(x.dtype)).float()
    fg = torch.einsum("bsd,dh->bsh", xi, p["wf"].to(x.dtype)).float()

    st = state if state is not None else init_mlstm_state(cfg, b, device=x.device)
    if s > 1 and s % chunk == 0:
        new, y = _mlstm_chunkwise(q, k, v, ig, fg, st, chunk)
    else:
        new, y = _mlstm_sequential(q, k, v, ig, fg, st)
    y = y.to(x.dtype).reshape(b, s, di)
    y = y * F.silu(z)
    return y @ p["down"].to(x.dtype), new


def _mlstm_sequential(q, k, v, ig, fg, st: MLSTMState):
    """Step by step (the oracle, and the decode path: one state update per
    token) -> (MLSTMState, y (B,S,H,dh) fp32)."""
    c, n, m = st
    ys = []
    for t in range(q.shape[1]):
        qt, kt, vt = q[:, t].float(), k[:, t].float(), v[:, t].float()  # (B,H,dh)
        it, ft = ig[:, t], fg[:, t]  # (B,H)
        logf = F.logsigmoid(ft)
        m_new = torch.maximum(logf + m, it)
        i_ = torch.exp(it - m_new)
        f_ = torch.exp(logf + m - m_new)
        c = f_[..., None, None] * c + i_[..., None, None] * (vt[..., :, None] * kt[..., None, :])
        n = f_[..., None] * n + i_[..., None] * kt
        hn = torch.einsum("bhvk,bhk->bhv", c, qt)
        denom = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, qt)),
                              torch.exp(-m_new))
        ys.append(hn / denom[..., None])
        m = m_new
    return MLSTMState(c=c, n=n, m=m), torch.stack(ys, 1)


def _mlstm_chunkwise(q, k, v, ig, fg, st: MLSTMState, chunk: int):
    """Stabilised chunkwise-parallel mLSTM, the reference's algebra term for
    term. Within a chunk of L steps everything is (L, L) and (L, dh)
    products; the matrix state C, n, m is formed only at chunk ends. With
    b_j = cumsum(log sig f), M_j = max(m_prev, cummax_{l<=j}(i_l - b_l)) and
    the stored state C = e^{-m} C_true:
      intra_jl = e^{(i_l - b_l) - M_j} (l <= j),  inter_j = e^{m_prev - M_j},
      y_j = [(S . intra) V + inter_j (q C_prev)] / max(|.|_n, e^{-m_j}).
    -> (MLSTMState, y (B,S,H,dh) fp32)."""
    b, s, h, dh = q.shape
    L = chunk
    nc = s // L

    def chunks(t):
        return t.reshape(b, nc, L, *t.shape[2:]).float()

    qf, kf, vf, igf, fgf = (chunks(t) for t in (q, k, v, ig, fg))
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))  # (j, l): l <= j
    c, n, m_prev = st
    ys = []
    for ci in range(nc):
        qc_, kc_, vc_ = qf[:, ci], kf[:, ci], vf[:, ci]  # (B,L,H,dh)
        ic_, fc_ = igf[:, ci], fgf[:, ci]  # (B,L,H)
        logf = F.logsigmoid(fc_)
        bj = torch.cumsum(logf, dim=1)  # cumulative decay
        a = ic_ - bj  # i_l - b_l
        mj_run = torch.maximum(torch.cummax(a, dim=1).values, m_prev[:, None, :])  # M_j
        m_j = bj + mj_run  # per-position stabiliser
        # intra-chunk decay weights w_lj = exp((i_l - b_l) - M_j), causal l <= j
        w = torch.exp(a[:, :, None, :] - mj_run[:, None, :, :])  # (B,l,j,H)
        w = torch.where(mask.T[None, :, :, None], w, torch.zeros((), device=q.device))
        qk = torch.einsum("bjhd,blhd->bljh", qc_, kc_)  # q_j . k_l
        sw = qk * w
        intra = torch.einsum("bljh,blhd->bjhd", sw, vc_)  # (B,j,H,dh)
        inter_f = torch.exp(m_prev[:, None, :] - mj_run)  # (B,j,H)
        # C is (v-dim, k-dim); q contracts the k-dim, as in the sequential form
        inter = torch.einsum("bjhe,bhde->bjhd", qc_, c) * inter_f[..., None]
        num = intra + inter
        # normaliser: q_j . n_j with the same weights (n accumulates k's)
        qn = sw.sum(1)
        qn = qn + torch.einsum("bjhd,bhd->bjh", qc_, n) * inter_f
        denom = torch.maximum(torch.abs(qn), torch.exp(-m_j))
        ys.append(num / denom[..., None])
        # chunk-end state (the weights at row j = L-1)
        wl = torch.exp(a - mj_run[:, -1:, :])  # (B,l,H)
        decay_end = torch.exp(m_prev - mj_run[:, -1, :])
        c = decay_end[..., None, None] * c + torch.einsum("blh,blhd,blhe->bhde", wl, vc_, kc_)
        n = decay_end[..., None] * n + torch.einsum("blh,blhd->bhd", wl, kc_)
        m_prev = m_j[:, -1, :]
    return MLSTMState(c=c, n=n, m=m_prev), torch.stack(ys, 1).reshape(b, s, h, dh)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(generator: torch.Generator, cfg: ModelConfig, place=as_drawn) -> dict:
    """The reference's leaves, shapes and fan-ins. The recurrent matrix r is
    dense (d, 4d) over (z, i, f, o), as the reference keeps it: its block-
    diagonal per-head form (the paper's) regressed there
    (`repro/models/xlstm.py:201-206`)."""
    d = cfg.d_model
    f = int(d * 4 / 3) // 8 * 8  # gated 4/3 FFN, 8-aligned
    return {
        "wz": place(dense_init(generator, (d, d)), ("embed", "mlp")),
        "wi": place(dense_init(generator, (d, d)), ("embed", "mlp")),
        "wf": place(dense_init(generator, (d, d)), ("embed", "mlp")),
        "wo": place(dense_init(generator, (d, d)), ("embed", "mlp")),
        "r": place(dense_init(generator, (d, 4 * d)), ("embed", "mlp")),
        "ffn_up": place(dense_init(generator, (d, 2 * f)), ("embed", "mlp")),
        "ffn_down": place(dense_init(generator, (f, d), fan_in=f), ("mlp", "embed")),
        "norm": place(ones_init((d,)), (None,)),
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, D)
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor


SLSTM_STATE_AXES = SLSTMState(c=("batch", "mlp"), n=("batch", "mlp"),
                              h=("batch", "mlp"), m=("batch", "mlp"))


def init_slstm_state(cfg: ModelConfig, batch: int, device=None) -> SLSTMState:
    def zeros():
        return torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)

    return SLSTMState(c=zeros(), n=zeros(), h=zeros(),
                      m=torch.full((batch, cfg.d_model), NEG_STATE, dtype=torch.float32,
                                   device=device))


def slstm_block(p, x, cfg: ModelConfig, state: Optional[SLSTMState] = None):
    """x: (B,S,D) -> (y, new_state): the recurrence step by step in fp32,
    then the post-norm gated GELU FFN (4/3)."""
    z_in = x @ p["wz"].to(x.dtype)
    i_in = x @ p["wi"].to(x.dtype)
    f_in = x @ p["wf"].to(x.dtype)
    o_in = x @ p["wo"].to(x.dtype)
    c, n, hprev, m = state if state is not None else init_slstm_state(
        cfg, x.shape[0], device=x.device)
    r = p["r"].float()  # (D, 4D)
    ys = []
    for t in range(x.shape[1]):
        zt, it, ft, ot = (u[:, t].float() for u in (z_in, i_in, f_in, o_in))  # (B,D)
        rz, ri, rf, ro = torch.chunk(hprev @ r, 4, dim=-1)
        zt, it, ft, ot = zt + rz, it + ri, ft + rf, ot + ro
        logf = F.logsigmoid(ft)
        m_new = torch.maximum(logf + m, it)
        i_ = torch.exp(it - m_new)
        f_ = torch.exp(logf + m - m_new)
        c = f_ * c + i_ * torch.tanh(zt)
        n = f_ * n + i_
        hprev = torch.sigmoid(ot) * c / torch.clamp_min(n, 1e-6)
        m = m_new
        ys.append(hprev)
    y = torch.stack(ys, 1).to(x.dtype)  # (B,S,D)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    u1, u2 = torch.chunk(y @ p["ffn_up"].to(x.dtype), 2, dim=-1)
    y = (F.gelu(u1, approximate="tanh") * u2) @ p["ffn_down"].to(x.dtype)
    return y, SLSTMState(c=c, n=n, h=hprev, m=m)
