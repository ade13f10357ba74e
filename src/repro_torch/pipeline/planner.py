"""Per-layer dense / ECR / PECR / BSR / int8 planning over the LayerGraph IR
(counterpart of `repro.pipeline.planner`).

The planner walks a graph's conv units on a calibration batch, measures per
unit the channel-block occupancy the ECR kernel would run at (shared-union
compaction, then per-sample block occupancy, averaged), and emits a
`PipelinePlan`: one `LayerPlan` per unit — sparse when the occupancy is at
most `occ_threshold`, fused with its pool (PECR) when the registry's fusion
rule admits it. Two more axes ride on that choice, both decided by the
registry's modeled roofline time (`unit_model_us`):
- weight sparsity: a layer whose params' block density is at most
  `bsr_threshold` runs ("conv", "bsr") when that models faster;
- precision (`int8=True`): a sparse or BSR layer moves to its int8 sibling
  when that models faster, and the upgrades are then probed against the
  dense fp32 logits and demoted until the top-1 agreement meets the budget.
`calibration=` (a `repro_torch.obs.calibrate.CalibrationDB`) puts every
modeled-time comparison on measured effective constants and re-checks the
occupancy rule against the dense path; `tiles=` (a DB holding tile-search
winners) stamps each layer's measured-best `TileConfig` onto
`LayerPlan.tile`. An empty DB, or none, plans bit-identically.
`run_plan` executes a plan over any batch of the calibrated shape, one
whole-batch op per layer at its tile, every op resolved through the
registry.

Not ported: `use_pallas=` (every sparse layer runs a CUDA kernel) and
`run_plan_sharded` (ROADMAP queue 1, item 13).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F

from repro_torch.graph import as_graph
from repro_torch.graph.executor import run_head, run_unit
from repro_torch.graph.ir import ConvSpec, LayerGraph, PoolSpec, graph_weights, weight_shapes
from repro_torch.graph.registry import fusion_eligible, get_op, unit_model_us
from repro_torch.kernels.tiles import TileConfig, resolve_block_c
from repro_torch.sparse_weights.format import weight_block_density


@dataclass(frozen=True)
class LayerPlan:
    """One conv unit's placement decision."""

    index: int  # conv index in network order (0-based)
    stage: int  # pooling stage (number of pools crossed before this conv)
    slot: int  # index within the stage
    kind: str  # "conv" | "conv_pool"
    impl: str  # "dense" | "ecr_pallas" | "pecr_pallas" | "bsr" | "ecr_int8" | "bsr_int8"
    occupancy: float  # measured mean channel-block occupancy of the input
    in_shape: tuple  # (C, H, W) entering the layer (pre-padding)
    out_shape: tuple  # (C, H, W) leaving the layer (post-pool if any)
    conv: ConvSpec  # the unit's conv node (k, stride, pad)
    relu: bool = True
    pool: PoolSpec | None = None
    weight_density: float = 1.0  # measured BSR block density of the params
    tile: TileConfig | None = None  # searched kernel geometry (None = defaults)

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
    int8_report: object = None  # quant.ops.Int8Report when int8 planning probed

    def counts(self) -> dict:
        c = {"dense": 0, "sparse": 0, "fused": 0, "bsr": 0, "int8": 0}
        for lp in self.layers:
            op = get_op(lp.kind, lp.impl)
            if op.quantized:
                c["int8"] += 1  # counted in its own bucket and its family's
            if op.weight_sparse:
                c["bsr"] += 1
            elif op.sparse:
                c["sparse"] += 1
                if lp.kind == "conv_pool":
                    c["fused"] += 1
            else:
                c["dense"] += 1
        return c


def occupancy_stat(x: torch.Tensor, block_c: int = 0,
                   n_valid: int | None = None, tile=None,
                   dtype_bytes: int = 4) -> torch.Tensor:
    """Channel-block occupancy measured the way the batched kernel schedules:
    shared-union channel compaction, then per-sample block occupancy on the
    packed layout (mean_b cnt_b / n_cb of `batch_block_schedule`).

    x: (N,C,H,W) or (C,H,W). `n_valid` restricts the statistic to the first
    n_valid samples (the real requests of a padded serving bucket), clamped
    to [0, N]; 0 reports 0.0. `tile` (a TileConfig) takes precedence over
    `block_c`. `dtype_bytes` is the operand width the block size is resolved
    at (1 for the int8 kernel). Returns a 0-dim float32 tensor."""
    if x.ndim == 3:
        x = x[None]
    n, c, h, w = x.shape
    t = tile if tile is not None and tile else TileConfig(block_c=block_c)
    bc = resolve_block_c(h, w, c, t, dtype_bytes)
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


def measure_occupancy(x: torch.Tensor, block_c: int = 0, tile=None,
                      dtype_bytes: int = 4) -> float:
    """Concrete-value wrapper of `occupancy_stat`."""
    return float(occupancy_stat(x, block_c, tile=tile, dtype_bytes=dtype_bytes))


def plan_network(params, calib: torch.Tensor, graph=None, *,
                 occ_threshold: float = 0.75, block_c: int = 0,
                 bsr_threshold: float = 0.5, calibration=None, tiles=None,
                 int8: bool = False, int8_budget: float = 0.98) -> PipelinePlan:
    """Walk the graph's conv units on a calibration batch, emit the schedule.

    A unit goes sparse when its measured occupancy is <= occ_threshold; a
    sparse unit that passes the registry's fusion rule runs the fused
    conv+ReLU+pool op. The dense oracle (F.conv2d) produces each next
    calibration input.

    `calibration` (a `CalibrationDB`) prices every modeled-time comparison
    below at measured effective constants, and re-checks the occupancy rule:
    a layer the threshold sent sparse falls back to dense when the
    calibrated model says the measured sparse kernel loses to the measured
    dense path at this occupancy. The re-check only fires for keys the DB
    covers, so an empty DB (or none) plans bit-identically.

    When a layer's weight block density is <= `bsr_threshold`,
    ("conv", "bsr") competes with that choice on modeled roofline time and
    displaces it iff it wins (BSR reads every window but only the live
    weight blocks).

    `tiles` (a `CalibrationDB` holding `obs.tilesearch` winners, often the
    same object as `calibration`) stamps the stored measured-best
    `TileConfig` of the chosen (kind, impl) at the layer's shape onto
    `LayerPlan.tile`, with the occupancy re-measured at that geometry.

    `int8=True` then upgrades a sparse or BSR layer to its int8 sibling
    (`ecr_int8` / `bsr_int8`) iff the quantized model wins, with occupancy
    re-measured at the int8 block size and the int8 impl's own stored tile,
    and probes the result: int8 layers are demoted back to their fp32
    choice, least modeled saving first, until top-1 agreement with the
    dense fp32 logits on the calibration batch is >= `int8_budget`. The
    probe lands on the plan as `plan.int8_report`."""
    from repro_torch.obs.calibrate import unit_shape_key

    graph = as_graph(graph)
    if calib.ndim == 3:
        calib = calib[None]
    if calibration is not None and not calibration:
        calibration = None  # empty DB == no calibration, one code path
    conv_ws, _ = graph_weights(params)
    layers = []
    fp32_alt: dict = {}  # conv index -> the (kind, impl, tile, occ) int8 displaced
    q_saving: dict = {}  # conv index -> modeled us the int8 upgrade saved
    x = calib
    batch = int(calib.shape[0])
    for unit, w in zip(graph.units(), conv_ws):
        occ = measure_occupancy(x, block_c)
        wd = weight_block_density(w)
        go_sparse = occ <= occ_threshold
        if go_sparse:
            fused = get_op("conv", "ecr_pallas").fused_with
            if fused is not None and fusion_eligible(unit):
                kind, impl = "conv_pool", fused
            else:
                kind, impl = "conv", "ecr_pallas"
        else:
            kind, impl = "conv", "dense"
        if go_sparse and calibration is not None and (
                calibration.covers(kind, impl, block_c)
                or calibration.covers("conv", "dense", block_c)):
            sparse_us = unit_model_us(kind, impl, unit, occupancy=occ,
                                      batch=batch, block_c=block_c,
                                      calibration=calibration)
            dense_us = unit_model_us("conv", "dense", unit, batch=batch,
                                     block_c=block_c, calibration=calibration)
            if dense_us < sparse_us:
                kind, impl = "conv", "dense"
        if wd <= bsr_threshold:
            base_us = unit_model_us(kind, impl, unit, occupancy=occ,
                                    batch=batch, block_c=block_c,
                                    calibration=calibration)
            bsr_us = unit_model_us("conv", "bsr", unit, weight_density=wd,
                                   batch=batch, block_c=block_c,
                                   calibration=calibration)
            if bsr_us < base_us:
                kind, impl = "conv", "bsr"
        tile = None
        if tiles is not None and get_op(kind, impl).pallas:
            stored = tiles.best_tile(kind, impl, unit_shape_key(unit))
            if stored:
                tile = stored
                if get_op(kind, impl).sparse:
                    # the statistic must describe the schedule the winner runs
                    occ = measure_occupancy(x, block_c, tile=tile)
        if int8:
            op = get_op(kind, impl)
            q_impl = "bsr_int8" if op.weight_sparse else (
                "ecr_int8" if op.sparse else None)
            if q_impl is not None:
                q_tile = tiles.best_tile("conv", q_impl, unit_shape_key(unit)) \
                    if tiles is not None else None
                q_occ = occ
                if get_op("conv", q_impl).sparse:
                    # int8 operands resolve wider channel blocks
                    q_occ = measure_occupancy(x, block_c, tile=q_tile,
                                              dtype_bytes=1)
                base_us = unit_model_us(kind, impl, unit, occupancy=occ,
                                        weight_density=wd, batch=batch,
                                        block_c=block_c, tile=tile,
                                        calibration=calibration)
                q_us = unit_model_us("conv", q_impl, unit, occupancy=q_occ,
                                     weight_density=wd, batch=batch,
                                     block_c=block_c, tile=q_tile,
                                     calibration=calibration)
                if q_us < base_us:
                    fp32_alt[unit.index] = (kind, impl, tile, occ)
                    q_saving[unit.index] = base_us - q_us
                    kind, impl, tile, occ = "conv", q_impl, q_tile, q_occ
        x = run_unit(x, w, unit, "conv", "dense")
        layers.append(LayerPlan(
            index=unit.index, stage=unit.stage, slot=unit.slot, kind=kind,
            impl=impl, occupancy=occ, in_shape=unit.in_shape,
            out_shape=unit.out_shape, conv=unit.conv, relu=unit.relu,
            pool=unit.pool, weight_density=wd, tile=tile))
    plan = PipelinePlan(layers=tuple(layers), occ_threshold=occ_threshold,
                        block_c=block_c, graph=graph)
    if int8:
        plan = _probe_int8(plan, params, calib, fp32_alt, q_saving, int8_budget)
    return plan


def _probe_int8(plan: PipelinePlan, params, calib: torch.Tensor,
                fp32_alt: dict, q_saving: dict, budget: float) -> PipelinePlan:
    """Accuracy-gate a plan's int8 placements: planned logits vs the dense
    fp32 logits on the calibration batch. While top-1 agreement < `budget`,
    demote the int8 layer with the least modeled saving back to its
    recorded fp32 choice and probe again. With every int8 layer demoted the
    plan is fp32 again, so the loop ends. Returns the plan with its
    `int8_report`."""
    from repro_torch.graph.executor import run_graph
    from repro_torch.quant.ops import Int8Report

    ref = run_graph(plan.graph, params, calib, "dense")

    def probe(p):
        got = run_plan(p, params, calib)
        agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
        return agree, float((got - ref).abs().max())

    agree, drift = probe(plan)
    demoted = []
    order = sorted(fp32_alt, key=lambda i: q_saving[i])  # cheapest give-back
    layers = list(plan.layers)
    while agree < budget and order:
        i = order.pop(0)
        kind, impl, tile, occ = fp32_alt[i]
        pos = next(p for p, lp in enumerate(layers) if lp.index == i)
        layers[pos] = replace(layers[pos], kind=kind, impl=impl, tile=tile,
                              occupancy=occ)
        demoted.append(i)
        plan = replace(plan, layers=tuple(layers))
        agree, drift = probe(plan)
    report = Int8Report(
        layers=tuple(i for i in sorted(fp32_alt) if i not in demoted),
        max_logit_drift=drift, top1_agreement=agree, demoted=tuple(demoted))
    return replace(plan, int8_report=report)


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
    """Execute the planned layer sequence over a batch: (N,C,H,W) -> logits,
    each layer at its `LayerPlan.tile`.

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
            occs.append(occupancy_stat(x, plan.block_c, n_valid, tile=lp.tile))
        x = run_unit(x, w, lp.to_unit(), lp.kind, lp.impl, plan.block_c,
                     tile=lp.tile)
    logits = run_head(x, dense_ws, plan.graph.head())
    if collect_occupancy:
        return logits, torch.stack(occs)
    return logits
