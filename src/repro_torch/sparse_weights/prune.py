"""Magnitude pruning of LayerGraph params to BSR block patterns
(counterpart of `repro.sparse_weights.prune`).

Per layer, the (bt, bf) blocks of the weight's GEMM view are ranked by L2
norm and everything outside the top ceil(density * n_blocks) is zeroed. The
block shape comes from `format.weight_block`, so the zeros land exactly on
the blocks the BSR kernel's schedule skips. The `PruneReport` carries the
achieved per-layer block density (coarse block grids on small layers
quantize hard) and the logit drift of the dense forward on a probe batch.
The work runs in torch on the params' own device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.graph.ir import graph_weights
from repro_torch.sparse_weights.format import block_norms, conv_weight_matrix, weight_block


@dataclass(frozen=True)
class LayerPruneStat:
    """One pruned weight: what was asked for vs what the block grid allowed."""

    name: str  # "conv_1" / "dense_2"
    shape: tuple  # original weight shape
    block: tuple  # (bt, bf) tiling the zeros are aligned to
    target_density: float
    achieved_density: float  # kept_blocks / total_blocks
    kept_blocks: int
    total_blocks: int


@dataclass(frozen=True)
class PruneReport:
    layers: tuple  # tuple[LayerPruneStat, ...]
    density: float  # block-weighted overall achieved density
    max_logit_drift: float | None = None  # max |dense(pruned) - dense(orig)|
    top1_agreement: float | None = None  # argmax match rate on the probe

    def by_name(self) -> dict:
        return {s.name: s for s in self.layers}


def prune_matrix(m: torch.Tensor, density: float, block: tuple):
    """Zero all but the top-|norm| ceil(density * n) (bt, bf) blocks of a 2-D
    matrix. Returns (pruned, kept_blocks, total_blocks).

    The ranking is a stable sort by descending norm (ties break on block scan
    order, so the same weights always prune alike), and a zero-norm block is
    never counted as kept, even when ranked into the top-k: kept_blocks is
    what `weight_block_density` will measure."""
    bt, bf = block
    r, c = m.shape
    nr, nc = -(-r // bt), -(-c // bf)
    total = nr * nc
    norms = block_norms(m, block).flatten()
    keep = int(math.ceil(min(max(float(density), 0.0), 1.0) * total))
    mask = torch.zeros(total, dtype=torch.bool, device=m.device)
    if keep:
        order = torch.argsort(-norms, stable=True)
        mask[order[:keep]] = True
    mask &= norms > 0
    kept = int(mask.sum())
    mask = mask.reshape(nr, nc).repeat_interleave(bt, 0)[:r].repeat_interleave(bf, 1)[:, :c]
    return m * mask.to(m.dtype), kept, total


def prune_graph_params(params, density: float, graph=None, *,
                       per_layer: dict | None = None, prune_dense: bool = True,
                       probe=None):
    """Prune a {"conv": [...], "dense": [...]} params dict to BSR block
    patterns at a per-layer target density.

    `per_layer` overrides the target of individual conv layers by 0-based
    conv index. Dense-head weights are pruned at the default target on their
    (d_out, d_in) orientation unless `prune_dense=False`. `probe` (an
    (N,C,H,W) batch; needs `graph`) measures the max |logit| drift and top-1
    agreement of the dense forward before vs after pruning. Returns
    (pruned_params, PruneReport)."""
    conv_ws, dense_ws = graph_weights(params)
    per_layer = per_layer or {}
    stats = []
    new_conv = []
    for i, w in enumerate(conv_ws):
        target = float(per_layer.get(i, density))
        mat = conv_weight_matrix(w)
        block = weight_block(mat.shape[0], mat.shape[1])
        pruned, kept, total = prune_matrix(mat, target, block)
        new_conv.append(pruned.reshape(w.shape).contiguous())
        stats.append(LayerPruneStat(
            name=f"conv_{i + 1}", shape=tuple(w.shape), block=block,
            target_density=target, achieved_density=kept / total,
            kept_blocks=kept, total_blocks=total))
    new_dense = []
    for i, w in enumerate(dense_ws):
        if not prune_dense:
            new_dense.append(w)
            continue
        mat = w.T  # (d_out, d_in): rows = outputs, like conv's O
        block = weight_block(mat.shape[0], mat.shape[1])
        pruned, kept, total = prune_matrix(mat, float(density), block)
        new_dense.append(pruned.T.contiguous())
        stats.append(LayerPruneStat(
            name=f"dense_{i + 1}", shape=tuple(w.shape), block=block,
            target_density=float(density), achieved_density=kept / total,
            kept_blocks=kept, total_blocks=total))
    pruned_params = {"conv": new_conv, "dense": new_dense}
    kept = sum(s.kept_blocks for s in stats)
    total = sum(s.total_blocks for s in stats)
    drift = agree = None
    if probe is not None:
        if graph is None:
            raise ValueError("prune_graph_params needs graph= to measure "
                             "probe logit drift")
        from repro_torch.graph import as_graph
        from repro_torch.graph.executor import run_graph

        g = as_graph(graph)
        ref = run_graph(g, params, probe, impl="dense")
        got = run_graph(g, pruned_params, probe, impl="dense")
        drift = float((got - ref).abs().max())
        agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    return pruned_params, PruneReport(
        layers=tuple(stats), density=kept / max(total, 1),
        max_logit_drift=drift, top1_agreement=agree)
