"""Mixture-of-Experts FFN with capacity-based top-k routing, GShard-style
drops (counterpart of `repro.models.moe`).

Dispatch is ECR again, at token granularity: the (token, expert) pairs are
the nonzeros of the routing matrix, compacted into per-expert capacity
buffers that run as dense per-expert products (sparse scheduling, dense
arithmetic, as in the conv kernels):

  1. top-k gating in fp32 -> (token, expert) pairs
  2. stable argsort by expert id -> slot within its expert by segment rank
  3. the kept rows scattered into the (E, C, D) buffer (pairs past the
     capacity C drop)
  4. three per-expert products, batched over the experts (`torch.bmm`)
  5. gathered back, dropped pairs zeroed, gate-weighted sum over the k picks

The reference's expert products are plain einsums, not a Pallas kernel, and
so are these. The reference's sharding constraints (experts over the model
axis) have no counterpart: the port has no mesh.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparse_ffn import activation_fn
from repro_torch.models.layers import as_drawn, dense_init


def init_moe(generator: torch.Generator, cfg: ModelConfig, place=as_drawn) -> dict:
    """router (d, E); w1, w3 (E, d, f) and w2 (E, f, d), each expert at the
    fan-in of its own product; `shared.{w1, w3, w2}` at width
    f * n_shared_experts when the config has shared experts. `place` takes
    each leaf as it is drawn."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    p = {"router": place(dense_init(generator, (d, e)), ("embed", None))}
    p["w1"] = place(dense_init(generator, (e, d, f), fan_in=d), ("experts", "embed", "mlp"))
    p["w3"] = place(dense_init(generator, (e, d, f), fan_in=d), ("experts", "embed", "mlp"))
    p["w2"] = place(dense_init(generator, (e, f, d), fan_in=f), ("experts", "mlp", "embed"))
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"w1": place(dense_init(generator, (d, fs)), ("embed", "mlp"))}
        p["shared"]["w3"] = place(dense_init(generator, (d, fs)), ("embed", "mlp"))
        p["shared"]["w2"] = place(dense_init(generator, (fs, d), fan_in=fs), ("mlp", "embed"))
    return p


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Rows per expert buffer: ceil(T * k * capacity_factor / E) rounded up
    to 8, at least 8."""
    c = math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


class Routing(NamedTuple):
    gates: torch.Tensor  # (T, k) fp32, renormalised over the k picks
    eidx: torch.Tensor  # (T, k) int64 expert of each pick
    slots: torch.Tensor  # (T*k,) int64 slot of each pair within its expert
    keep: torch.Tensor  # (T*k,) bool, slot < cap
    cap: int
    aux: torch.Tensor  # () fp32 load-balancing loss


def route(router, xt, cfg: ModelConfig) -> Routing:
    """Top-k routing of the (T, D) tokens `xt` in fp32. `torch.matmul` takes
    no mixed types (the reference leans on JAX promoting bf16 @ f32), so
    both operands are cast. The Switch aux loss coef * E * sum(mean(probs) *
    counts / (T k)): the counts carry no gradient."""
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    gates, eidx = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    fe = eidx.reshape(-1)
    counts = torch.zeros(e, dtype=torch.float32, device=xt.device).index_add_(
        0, fe, torch.ones_like(fe, dtype=torch.float32))
    aux = cfg.router_aux_loss * e * torch.sum(probs.mean(0) * (counts / (t * k)))
    # slot = rank of the pair among its expert's pairs, in token order
    order = torch.argsort(fe, stable=True)
    se = fe[order]
    pos = torch.arange(t * k, device=xt.device)
    first = torch.ones_like(se, dtype=torch.bool)
    first[1:] = se[1:] != se[:-1]
    slot_sorted = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    slots = torch.empty_like(slot_sorted).index_copy_(0, order, slot_sorted)
    cap = _capacity(t, cfg)
    return Routing(gates, eidx, slots, slots < cap, cap, aux)


def moe_ffn(p, x, cfg: ModelConfig):
    """x: (B, S, D) -> (y, aux_loss). The capacity comes from this call's
    T = B * S, so prefill and decode each get their own."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xt = x.reshape(t, d)
    r = route(p["router"], xt, cfg)
    cap = r.cap
    token_of = torch.arange(t * k, device=x.device) // k
    # A dropped pair goes to row E * cap, which is cut off before the
    # products: each kept slot receives exactly one row, so the copy is the
    # reference's scatter-add, and a dropped row gets no gradient.
    flat = torch.where(r.keep, r.eidx.reshape(-1) * cap + r.slots, e * cap)
    buf = x.new_zeros((e * cap + 1, d)).index_copy(0, flat, xt[token_of])
    buf = buf[:e * cap].reshape(e, cap, d)

    act = activation_fn(cfg.mlp_activation)
    h = act(torch.bmm(buf, p["w1"].to(x.dtype))) * torch.bmm(buf, p["w3"].to(x.dtype))
    out_buf = torch.bmm(h, p["w2"].to(x.dtype)).reshape(e * cap, d)
    rows = torch.where(r.keep[:, None], out_buf[flat.clamp(max=e * cap - 1)], 0.0)
    y = (rows.reshape(t, k, d) * r.gates[..., None].to(x.dtype)).sum(1)

    if cfg.n_shared_experts:
        sp = p["shared"]
        hs = act(xt @ sp["w1"].to(x.dtype)) * (xt @ sp["w3"].to(x.dtype))
        y = y + hs @ sp["w2"].to(x.dtype)
    return y.reshape(b, s, d), r.aux
