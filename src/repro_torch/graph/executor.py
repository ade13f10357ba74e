"""LayerGraph executor: walk the units, dispatch every op through the
registry (counterpart of `repro.graph.executor`).

Structural concerns (padding, unfused ReLU/pool around a plain conv, flatten,
the dense head) live here; impl selection lives in
`repro_torch.graph.registry`; the kernels live in `repro_torch.kernels`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.graph.ir import ConvUnit, LayerGraph, PoolSpec, graph_weights, pool_out_len
from repro_torch.graph.registry import get_op, unit_impl


def pad2d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """`pad`-pixel spatial zero padding, (C,H,W) / (N,C,H,W) (no-op pad=0)."""
    if pad == 0:
        return x
    return F.pad(x, (pad, pad, pad, pad))


def maxpool2d(x: torch.Tensor, pool: PoolSpec) -> torch.Tensor:
    """Max-pool the trailing two dims per `pool` (p, stride, mode).

    "valid" raises on an inexact tiling, "floor" drops the tail, "ceil" keeps
    a partial tail window; `F.max_pool2d(ceil_mode=True)` applies the same
    rule as `pool_out_len` (the last window starts inside the input)."""
    h, w = x.shape[-2:]
    oh, ow = pool_out_len(h, pool), pool_out_len(w, pool)  # validates mode
    y = F.max_pool2d(x, pool.p, pool.s, ceil_mode=pool.mode == "ceil")
    if tuple(y.shape[-2:]) != (oh, ow):
        raise RuntimeError(f"max_pool2d gave {tuple(y.shape[-2:])}, the pool "
                           f"rule says {(oh, ow)} for {pool} on ({h}, {w})")
    return y


def run_unit(x, w, unit: ConvUnit, kind: str, impl: str, block_c: int = 0,
             tile=None):
    """Execute one conv unit as (kind, impl): the fused op consumes the whole
    conv+ReLU+pool triple; a plain conv gets the unit's ReLU / unfused pool
    applied around it. `tile` is the layer's searched `TileConfig` (None =
    the impl's default geometry); impls without a kernel ignore it."""
    op = get_op(kind, impl)
    xp = pad2d(x, unit.conv.pad)
    if kind == "conv_pool":
        return op.forward(xp, w, stride=unit.conv.stride, pool=unit.pool,
                          block_c=block_c, tile=tile)
    x = op.forward(xp, w, stride=unit.conv.stride, block_c=block_c, tile=tile)
    if unit.relu:
        x = torch.relu(x)
    if unit.pool is not None:
        x = maxpool2d(x, unit.pool)
    return x


def run_units(x, conv_ws, units, impls, block_c: int = 0, tiles=None):
    """Run the conv body: `impls` is one (kind, impl) pair per unit; `tiles`
    (optional) one TileConfig-or-None per unit."""
    for i, (unit, (kind, impl), w) in enumerate(zip(units, impls, conv_ws)):
        tile = tiles[i] if tiles is not None else None
        x = run_unit(x, w, unit, kind, impl, block_c, tile=tile)
    return x


def run_head(x, dense_ws, head):
    """Flatten + the dense head ((N,C,H,W) -> (N,classes), or unbatched)."""
    x = x.reshape(x.shape[0], -1) if x.ndim == 4 else x.reshape(-1)
    for w, spec in zip(dense_ws, head):
        x = x @ w
        if spec.relu:
            x = torch.relu(x)
    return x


def uniform_impls(graph: LayerGraph, impl: str) -> tuple:
    """One whole-network impl string -> per-unit (kind, impl) assignments."""
    return tuple(unit_impl(u, impl) for u in graph.units())


def run_graph(graph: LayerGraph, params, x, impl: str = "dense",
              block_c: int = 0):
    """(C,H,W) or (N,C,H,W) -> logits through the whole graph at one uniform
    impl. Per-layer planned execution is `repro_torch.pipeline.run_plan`."""
    conv_ws, dense_ws = graph_weights(params)
    x = run_units(x, conv_ws, graph.units(), uniform_impls(graph, impl), block_c)
    return run_head(x, dense_ws, graph.head())
