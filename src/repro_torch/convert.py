"""Carry weights made by the JAX package into the port.

`torch.Generator` cannot reproduce `jax.random` bits, so a comparison of the
two packages makes its weights once (on the JAX side, as numpy arrays) and
hands the same values to both.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_jax(np_params: dict, device=None) -> dict:
    """{"conv": [(O,C,kh,kw)...], "dense": [(d_in,d_out)...]} of array-likes
    (numpy arrays, or anything `np.asarray` takes) -> the same layout of
    float32 tensors on `device` (None = the card). Layouts are kept as they
    are: conv weights stay OIHW, dense weights stay (d_in, d_out)."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    return {"conv": [t(w) for w in np_params["conv"]],
            "dense": [t(w) for w in np_params["dense"]]}
