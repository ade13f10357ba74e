"""Per-layer dense / ECR / PECR planning over the LayerGraph IR
(counterpart of `repro.pipeline.planner`).

The planner walks a graph's conv units on a calibration batch, measures per
unit the channel-block occupancy the ECR kernel would run at (shared-union
compaction, then per-sample block occupancy, averaged), and emits a
`PipelinePlan`: one `LayerPlan` per unit — sparse when the occupancy is at
most `occ_threshold`, fused with its pool (PECR) when the registry's fusion
rule admits it. `run_plan` executes a plan over any batch of the calibrated
shape, one whole-batch op per layer, every op resolved through the registry.

Not ported in this slice: `calibration=` (measured cost constants), `tiles=`
(searched geometry), `int8=` and `run_plan_sharded`. Weight-pruned layers
raise instead of planning BSR, whose kernel is a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.graph import as_graph
from repro_torch.graph.executor import run_head, run_unit
from repro_torch.graph.ir import ConvSpec, LayerGraph, PoolSpec, graph_weights, weight_shapes
from repro_torch.graph.registry import fusion_eligible, get_op
from repro_torch.kernels.tiles import TileConfig, resolve_block_c
from repro_torch.sparse_weights.format import weight_block_density


@dataclass(frozen=True)
class LayerPlan:
    """One conv unit's placement decision."""

    index: int  # conv index in network order (0-based)
    stage: int  # pooling stage (number of pools crossed before this conv)
    slot: int  # index within the stage
    kind: str  # "conv" | "conv_pool"
    impl: str  # "dense" | "ecr_pallas" | "pecr_pallas"
    occupancy: float  # measured mean channel-block occupancy of the input
    in_shape: tuple  # (C, H, W) entering the layer (pre-padding)
    out_shape: tuple  # (C, H, W) leaving the layer (post-pool if any)
    conv: ConvSpec  # the unit's conv node (k, stride, pad)
    relu: bool = True
    pool: PoolSpec | None = None
    weight_density: float = 1.0  # measured BSR block density of the params

    def to_unit(self):
        """The `ConvUnit` this plan entry executes (the plan, not a re-walk of
        the graph, is what `run_plan` runs)."""
        from repro_torch.graph.ir import ConvUnit

        return ConvUnit(index=self.index, stage=self.stage, slot=self.slot,
                        conv=self.conv, relu=self.relu, pool=self.pool,
                        in_shape=self.in_shape, out_shape=self.out_shape)


@dataclass(frozen=True)
class PipelinePlan:
    layers: tuple  # tuple[LayerPlan, ...]
    occ_threshold: float
    block_c: int  # 0 = auto per layer
    graph: LayerGraph  # the IR the plan was made for

    def counts(self) -> dict:
        c = {"dense": 0, "sparse": 0, "fused": 0}
        for lp in self.layers:
            if get_op(lp.kind, lp.impl).sparse:
                c["sparse"] += 1
                if lp.kind == "conv_pool":
                    c["fused"] += 1
            else:
                c["dense"] += 1
        return c


def occupancy_stat(x: torch.Tensor, block_c: int = 0,
                   n_valid: int | None = None) -> torch.Tensor:
    """Channel-block occupancy measured the way the batched kernel schedules:
    shared-union channel compaction, then per-sample block occupancy on the
    packed layout (mean_b cnt_b / n_cb of `batch_block_schedule`).

    x: (N,C,H,W) or (C,H,W). `n_valid` restricts the statistic to the first
    n_valid samples (the real requests of a padded serving bucket), clamped
    to [0, N]; 0 reports 0.0. Returns a 0-dim float32 tensor."""
    if x.ndim == 3:
        x = x[None]
    n, c, h, w = x.shape
    bc = resolve_block_c(h, w, c, TileConfig(block_c=block_c))
    n_cb = -(-c // bc)
    live = (x != 0).flatten(2).any(dim=2)  # (N, C) per-sample live channels
    if n_valid is not None:
        nv = max(0, min(int(n_valid), n))
        live = live & (torch.arange(n, device=x.device) < nv)[:, None]
    union_order = torch.argsort((~live.any(dim=0)).to(torch.int8), stable=True)
    packed = F.pad(live[:, union_order], (0, n_cb * bc - c))
    blk_live = packed.reshape(n, n_cb, bc).any(dim=2).float()  # (N, n_cb)
    if n_valid is None:
        return blk_live.mean()
    per_sample = blk_live.mean(dim=1)
    return per_sample[:nv].sum() / max(nv, 1)


def measure_occupancy(x: torch.Tensor, block_c: int = 0) -> float:
    """Concrete-value wrapper of `occupancy_stat`."""
    return float(occupancy_stat(x, block_c))


def plan_network(params, calib: torch.Tensor, graph=None, *,
                 occ_threshold: float = 0.75, block_c: int = 0,
                 bsr_threshold: float = 0.5) -> PipelinePlan:
    """Walk the graph's conv units on a calibration batch, emit the schedule.

    A unit goes sparse when its measured occupancy is <= occ_threshold; a
    sparse unit that passes the registry's fusion rule runs the fused
    conv+ReLU+pool op. The dense oracle (F.conv2d) produces each next
    calibration input. A layer whose weights are pruned to a block density
    <= `bsr_threshold` raises: the reference would consider its BSR kernel,
    which comes in a later slice of the port."""
    graph = as_graph(graph)
    if calib.ndim == 3:
        calib = calib[None]
    conv_ws, _ = graph_weights(params)
    layers = []
    x = calib
    for unit, w in zip(graph.units(), conv_ws):
        occ = measure_occupancy(x, block_c)
        wd = weight_block_density(w)
        if wd <= bsr_threshold:
            raise NotImplementedError(
                f"conv_{unit.index + 1} has weight block density {wd:.3f} <= "
                f"bsr_threshold {bsr_threshold}: BSR weight-sparse planning "
                "comes in a later slice of repro_torch")
        if occ <= occ_threshold:
            fused = get_op("conv", "ecr_pallas").fused_with
            if fused is not None and fusion_eligible(unit):
                kind, impl = "conv_pool", fused
            else:
                kind, impl = "conv", "ecr_pallas"
        else:
            kind, impl = "conv", "dense"
        x = run_unit(x, w, unit, "conv", "dense")
        layers.append(LayerPlan(
            index=unit.index, stage=unit.stage, slot=unit.slot, kind=kind,
            impl=impl, occupancy=occ, in_shape=unit.in_shape,
            out_shape=unit.out_shape, conv=unit.conv, relu=unit.relu,
            pool=unit.pool, weight_density=wd))
    return PipelinePlan(layers=tuple(layers), occ_threshold=occ_threshold,
                        block_c=block_c, graph=graph)


def validate_plan(plan: PipelinePlan, params, imgs) -> None:
    """Raise a clear ValueError on any plan/params/input mismatch: the input
    rank and (C,H,W) against the plan's first layer, and the params' conv and
    dense weights (count and shapes) against the plan's graph.

    The reference also runs its static verifier here (plan invariants,
    fusion legality, launch geometry, BSR density); that verifier is a later
    slice of the port."""
    if imgs.ndim not in (3, 4):
        raise ValueError(f"run_plan expects (C,H,W) or (N,C,H,W) images, got "
                         f"shape {tuple(imgs.shape)}")
    if not plan.layers:
        raise ValueError("run_plan got an empty PipelinePlan (no layers)")
    in_shape = tuple(imgs.shape[-3:])
    if in_shape != tuple(plan.layers[0].in_shape):
        raise ValueError(
            f"plan was calibrated for input shape {tuple(plan.layers[0].in_shape)}, "
            f"got images of shape {in_shape}")
    conv_ws, dense_ws = graph_weights(params)
    want_conv, want_dense = weight_shapes(plan.graph)
    if len(plan.layers) != len(want_conv):
        raise ValueError(f"plan has {len(plan.layers)} layers, its graph "
                         f"{len(want_conv)} conv units")
    got_conv = tuple(tuple(w.shape) for w in conv_ws)
    got_dense = tuple(tuple(w.shape) for w in dense_ws)
    if got_conv != tuple(want_conv):
        raise ValueError(f"params' conv weights {got_conv} do not match the "
                         f"plan's graph {tuple(want_conv)}")
    if got_dense != tuple(want_dense):
        raise ValueError(f"params' dense weights {got_dense} do not match the "
                         f"plan's graph {tuple(want_dense)}")


def run_plan(plan: PipelinePlan, params, imgs: torch.Tensor, *,
             collect_occupancy: bool = False, n_valid: int | None = None):
    """Execute the planned layer sequence over a batch: (N,C,H,W) -> logits.

    collect_occupancy=True also returns the per-layer observed channel-block
    occupancy of each layer's input (an (n_layers,) tensor) — the signal the
    serving engine's drift detector consumes; `n_valid` masks it to the first
    n_valid samples of a padded bucket."""
    if imgs.ndim == 3:
        imgs = imgs[None]
    validate_plan(plan, params, imgs)
    conv_ws, dense_ws = graph_weights(params)
    x = imgs
    occs = []
    for lp, w in zip(plan.layers, conv_ws):
        if collect_occupancy:
            occs.append(occupancy_stat(x, plan.block_c, n_valid))
        x = run_unit(x, w, lp.to_unit(), lp.kind, lp.impl, plan.block_c)
    logits = run_head(x, dense_ws, plan.graph.head())
    if collect_occupancy:
        return logits, torch.stack(occs)
    return logits
