"""FFN activations (counterpart of `repro.core.sparse_ffn.activation_fn`;
the block-sparse FFN forms come with the families that use them)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


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
