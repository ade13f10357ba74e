"""The paper's technique lifted to transformer FFNs (counterpart of
`repro.core.sparse_ffn`).

A ReLU-family MLP (minitron's squared ReLU) makes a hidden state
h = act(x @ W1) with exact zeros, so h @ W2 is a sparse x dense product whose
sparsity depends on the data: `block_occupancy(h, block)` is ECR's Ptr at
block granularity. `sparse_ffn_apply` is the dense equivalent of skipping the
dead blocks (mask, then matmul: the mask removes only all-zero blocks, so the
result equals the dense product), as the reference's is; `sparse_ffn_stats`
measures the sparsity that the roofline's useful-FLOP count reads. Blocks are
(8, 128) over (T, F); a T that 8 does not divide takes 1-row blocks, an F
that 128 does not divide one block over the whole row, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.sparsity import block_occupancy


def activation_fn(name: str):
    """`jax.nn.gelu` defaults to the tanh approximation, so "gelu" here is
    `F.gelu(approximate="tanh")`."""
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu":
        return torch.relu
    if name == "relu2":
        return lambda x: torch.square(torch.relu(x))
    raise ValueError(f"unknown activation {name!r}")


def _mean(mask):
    """The share of True in a bool tensor, rounded as the reference's
    `jnp.mean` is: XLA folds its division by the size into a product with the
    fp32 reciprocal, so the fp32 count (exact below 2^24) times 1 / size."""
    return mask.sum(dtype=torch.float32) * (1.0 / mask.numel())


def _hidden_occupancy(x, w1, activation: str, block) -> tuple:
    """(h, the (T/bt, F/bf) block occupancy of h, bt, bf)."""
    h = activation_fn(activation)(x @ w1)
    t, f = h.shape
    bt = block[0] if t % block[0] == 0 else 1
    bf = block[1] if f % block[1] == 0 else f
    return h, block_occupancy(h, (bt, bf)), bt, bf


def sparse_ffn_apply(x, w1, w2, activation: str = "relu2", block=(8, 128)):
    """x (T, D), w1 (D, F), w2 (F, D) -> (y (T, D), the fraction of live
    blocks of h as a 0-dim float32 tensor)."""
    h, occ, bt, bf = _hidden_occupancy(x, w1, activation, block)
    live = occ.repeat_interleave(bt, 0).repeat_interleave(bf, 1)
    h = torch.where(live, h, torch.zeros((), dtype=h.dtype, device=h.device))
    return h @ w2, _mean(occ)


def sparse_ffn_stats(x, w1, activation: str = "relu2", block=(8, 128)) -> dict:
    """Element sparsity, block occupancy and the skippable share of the
    down-projection's FLOPs of the hidden state h = act(x @ w1)."""
    h, occ, _, _ = _hidden_occupancy(x, w1, activation, block)
    return {"element_sparsity": float(_mean(h == 0)),
            "block_occupancy": float(_mean(occ)),
            "skippable_flop_frac": float(1.0 - _mean(occ))}
