"""Gradient compression with error feedback (counterpart of
`repro.optim.compression`).

Two schemes, each carrying what it drops in an error-feedback buffer that is
added back at the next step, so the bias vanishes over steps:

- int8: per-tensor absmax scale (max|g| / 127, at least 1e-12 / 127) and
  stochastic rounding, q = clip(round(g / scale + u), -127, 127) with u
  uniform in [-0.5, 0.5) from an explicit `torch.Generator` (the reference
  draws it from a `jax.random` key; the two give different bits, so a test
  compares the scale exactly and q within one step of round(g / scale));
- topk: keep every entry whose |g| reaches the k-th largest |g| of its
  tensor (k = max(1, int(numel * frac)); ties at the threshold are kept),
  zero the rest.

`compress -> (reduce) -> decompress` stands in for the raw gradient. As in
the reference, the train step does not call it (`run.grad_compression` is
read by nothing): it is a library for a data-parallel reduction.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def init_error_feedback(params) -> dict:
    """Zero float32 buffers shaped like `params`, on their devices."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def _int8_one(g, err, generator):
    g = g.float() + err
    scale = torch.clamp_min(g.abs().max(), 1e-12) / 127.0
    noise = torch.rand(g.shape, generator=generator, dtype=torch.float32,
                       device=generator.device).to(g.device) - 0.5
    q = torch.clamp(torch.round(g / scale + noise), -127, 127).to(torch.int8)
    return (q, scale), g - q.float() * scale


def _topk_one(g, err, frac: float):
    g = g.float() + err
    k = max(1, int(g.numel() * frac))
    flat = g.reshape(-1)
    thresh = torch.topk(flat.abs(), k).values[-1]
    kept = torch.where(flat.abs() >= thresh, flat, torch.zeros_like(flat)).reshape(g.shape)
    return kept, g - kept


def compress_grads(grads, err, *, scheme: str, generator: torch.Generator | None = None,
                   topk_frac: float = 0.01):
    """(compressed tree, new error tree). int8 leaves are (int8 q, float32
    scale) pairs and need `generator` for the rounding noise; topk leaves
    are float32 tensors with the dropped entries zeroed."""
    leaves, errs = tree_leaves(grads), tree_leaves(err)
    if scheme == "int8":
        if generator is None:
            raise ValueError("int8 compression draws its rounding noise from a generator")
        out = [_int8_one(g, e, generator) for g, e in zip(leaves, errs)]
    elif scheme == "topk":
        out = [_topk_one(g, e, topk_frac) for g, e in zip(leaves, errs)]
    else:
        raise ValueError(scheme)
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))


def decompress_grads(comp, *, scheme: str):
    """The float32 gradients a compressed tree stands for."""
    if scheme == "int8":
        return tree_map(lambda qs: qs[0].float() * qs[1], comp)
    if scheme == "topk":
        return comp
    raise ValueError(scheme)
