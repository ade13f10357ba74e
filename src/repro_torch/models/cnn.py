"""Trained-net activation statistics on random weights (counterpart of
`repro.models.cnn.shift_dead_channels`)."""
from __future__ import annotations

import torch

from repro_torch.graph.ir import graph_weights


def shift_dead_channels(params, rate: float = 0.04, shift: float = 0.12):
    """Shift a depth-growing fraction (`rate * depth`) of each conv's output
    filters negative so ReLU kills those channels, as trained VGG nets lose
    whole filters with depth (paper Fig. 2).

    The filters are chosen by a `torch.Generator` seeded with the layer's
    depth, so they differ from the reference's `jax.random.PRNGKey(depth)`
    choice at the same rates; parity tests shift on the JAX side and carry
    the weights across."""
    conv_ws, _ = graph_weights(params)
    shifted_ws = []
    for depth, w in enumerate(conv_ws):
        gen = torch.Generator().manual_seed(depth)
        u = torch.rand((w.shape[0], 1, 1, 1), generator=gen)
        bias_mask = (u < rate * depth).to(device=w.device, dtype=w.dtype)
        shifted_ws.append(w * (1.0 - bias_mask) - shift * bias_mask * w.abs())
    return {"conv": shifted_ws, "dense": list(params["dense"])}
