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
registry. `use_pallas=False` plans the paper's methods as plain oracles
instead: sparse layers on ("conv", "ecr") / ("conv_pool", "pecr"), with no
BSR and no int8 arm, as in the reference.

Every plan is verified before `plan_network` returns it and again by
`validate_plan` before every `run_plan` (`repro_torch.analysis`); the
serving engine's compiled runners verify once, when they are built, and
then run `run_plan_unchecked`.

`run_plan_sharded` runs a plan data-parallel over the slots of a 1-D
"data" mesh (`repro_torch.parallel`): each slot runs its slice of the batch,
with its own per-sample schedules, and the occupancy statistic is
aggregated over the shards. Its pieces (`shard_rows`, `shard_n_valid`,
`slot_params`, `aggregate_occupancy`) are shared with the serving engine's
`graph_runner.ShardedRunner`.
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
    impl: str  # "dense" | "ecr_pallas" | "pecr_pallas" | "ecr" | "pecr" | "bsr" | ...
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

        if self.conv.c_out == 0:
            raise ValueError(
                f"conv_{self.index + 1} carries no ConvSpec (c_out=0), as a "
                "plan that predates the LayerGraph IR; rebuild it with "
                "plan_network")
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
    to [0, N]; 0 reports 0.0. It is an int or a 0-dim integer tensor on x's
    device, which is read on the device, never on the host, so a captured
    runner replays with any count. `tile` (a TileConfig) takes precedence
    over `block_c`. `dtype_bytes` is the operand width the block size is
    resolved at (1 for the int8 kernel). Returns a 0-dim float32 tensor."""
    if x.ndim == 3:
        x = x[None]
    n, c, h, w = x.shape
    t = tile if tile is not None and tile else TileConfig(block_c=block_c)
    bc = resolve_block_c(h, w, c, t, dtype_bytes)
    n_cb = -(-c // bc)
    live = (x != 0).flatten(2).any(dim=2)  # (N, C) per-sample live channels
    if n_valid is not None:
        # one device-side path for both forms: on the card, a division by a
        # Python number multiplies by its reciprocal, which can differ from
        # the division by a tensor in the last bit
        if not isinstance(n_valid, torch.Tensor):
            n_valid = torch.full((), int(n_valid), dtype=torch.int32, device=x.device)
        nv = n_valid.to(device=x.device, dtype=torch.int32).clamp(0, n)
        valid = torch.arange(n, device=x.device) < nv
        live = live & valid[:, None]
    union_order = torch.argsort((~live.any(dim=0)).to(torch.int8), stable=True)
    packed = F.pad(live[:, union_order], (0, n_cb * bc - c))
    blk_live = packed.reshape(n, n_cb, bc).any(dim=2).float()  # (N, n_cb)
    if n_valid is None:
        return blk_live.mean()
    per_sample = blk_live.mean(dim=1)
    return torch.where(valid, per_sample, 0.0).sum() / nv.clamp(min=1)


def measure_occupancy(x: torch.Tensor, block_c: int = 0, tile=None,
                      dtype_bytes: int = 4) -> float:
    """Concrete-value wrapper of `occupancy_stat`."""
    return float(occupancy_stat(x, block_c, tile=tile, dtype_bytes=dtype_bytes))


def plan_network(params, calib: torch.Tensor, graph=None, *,
                 occ_threshold: float = 0.75, block_c: int = 0,
                 use_pallas: bool = True, bsr_threshold: float = 0.5,
                 calibration=None, tiles=None, int8: bool = False,
                 int8_budget: float = 0.98) -> PipelinePlan:
    """Walk the graph's conv units on a calibration batch, emit the schedule.

    A unit goes sparse when its measured occupancy is <= occ_threshold; a
    sparse unit that passes the registry's fusion rule runs the fused
    conv+ReLU+pool op. The dense oracle (F.conv2d) produces each next
    calibration input. `use_pallas` picks the sparse family: the CUDA
    kernels ("ecr_pallas" / "pecr_pallas"), or with False the plain
    oracles ("ecr" / "pecr"), which also turns the BSR and int8 arms off.

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
    probe lands on the plan as `plan.int8_report`.

    The plan is verified before it is returned (`analysis.assert_plan_ok`):
    an error there is a planner fault, or params that do not fit the graph.
    """
    from repro_torch.analysis import assert_plan_ok
    from repro_torch.obs.calibrate import unit_shape_key

    graph = as_graph(graph)
    if calib.ndim == 3:
        calib = calib[None]
    if calibration is not None and not calibration:
        calibration = None  # empty DB == no calibration, one code path
    sparse_conv = "ecr_pallas" if use_pallas else "ecr"
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
            fused = get_op("conv", sparse_conv).fused_with
            if fused is not None and fusion_eligible(unit):
                kind, impl = "conv_pool", fused
            else:
                kind, impl = "conv", sparse_conv
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
        if use_pallas and wd <= bsr_threshold:
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
        if int8 and use_pallas:
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
    assert_plan_ok(plan, params, graph=graph, batch=batch)
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
    rank and (C,H,W) against the plan's first layer and the dense weights'
    shapes against the plan's graph here; everything else (plan and graph
    invariants, fusion legality, launch geometry, weight counts and conv
    shapes, BSR density) is the static verifier's, which raises a
    `PlanVerificationError` (a ValueError) listing every error."""
    from repro_torch.analysis import assert_plan_ok

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
    batch = int(imgs.shape[0]) if imgs.ndim == 4 else 1
    assert_plan_ok(plan, params, graph=plan.graph, batch=batch)
    _, dense_ws = graph_weights(params)
    _, want_dense = weight_shapes(plan.graph)
    got_dense = tuple(tuple(w.shape) for w in dense_ws)
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
    n_valid samples of a padded bucket (an int, or a 0-dim tensor on the
    device).

    Every call verifies the plan first (`validate_plan`), as the
    reference's does when it traces; `run_plan_unchecked` is the body
    alone."""
    if imgs.ndim == 3:
        imgs = imgs[None]
    validate_plan(plan, params, imgs)
    return run_plan_unchecked(plan, params, imgs,
                              collect_occupancy=collect_occupancy, n_valid=n_valid)


def run_plan_unchecked(plan: PipelinePlan, params, imgs: torch.Tensor, *,
                       collect_occupancy: bool = False, n_valid=None):
    """`run_plan` on an (N,C,H,W) batch without `validate_plan`: the body a
    `serving.graph_runner.CompiledRunner` verifies once when it is built
    and then captures. It reads nothing back to the host."""
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


def shard_rows(mesh, shape) -> int:
    """Rows per shard of a batch of `shape` (N, ...) over `mesh`'s "data"
    axis. The logical rules decide the split (`parallel.logical_spec`):
    "batch" resolves to ("data",) exactly when the axis divides N. Raises
    on a mesh without a "data" axis or with other axes of more than one
    slot, and on a batch the axis does not divide."""
    from repro_torch.parallel.api import logical_spec

    if "data" not in mesh.axis_names:
        raise ValueError(f"run_plan_sharded needs a mesh with a 'data' axis, got axes "
                         f"{tuple(mesh.axis_names)}")
    n_dev = int(mesh.shape["data"])
    if mesh.size != n_dev:
        raise ValueError(f"run_plan_sharded splits the batch over 'data' alone; the "
                         f"mesh {mesh.shape} has other axes of more than one slot")
    n = int(shape[0])
    spec = logical_spec(tuple(shape), ("batch",) + (None,) * (len(shape) - 1), mesh)
    if n_dev > 1 and spec[0] != "data":
        raise ValueError(f"batch of {n} does not divide the {n_dev}-device data axis — "
                         f"pad to a device-aligned bucket (MicroBatcher(align={n_dev}))")
    return n // n_dev


def shard_n_valid(n_valid, shard: int, rows: int, device):
    """Shard `shard`'s count of real samples, clip(n_valid - shard * rows, 0,
    rows): an int for an int, a 0-dim int32 tensor on `device` for a tensor
    (read on the device, never on the host). Pad samples sit at the tail of
    the batch, so they land on the highest-index shards."""
    if isinstance(n_valid, torch.Tensor):
        return (n_valid.to(device=device, dtype=torch.int32) - shard * rows).clamp(0, rows)
    return min(max(int(n_valid) - shard * rows, 0), rows)


def slot_params(params, mesh, device) -> dict:
    """`params`' weights on `device`, placed through `mesh.place`: the
    tensors themselves where they live there, else copies the mesh keeps."""
    conv, dense = graph_weights(params)
    return {"conv": [mesh.place(w, device) for w in conv],
            "dense": [mesh.place(w, device) for w in dense]}


def aggregate_occupancy(occs: list, weights=None) -> torch.Tensor:
    """One (n_layers,) statistic from the shards' own, on the first shard's
    device, summed in shard order: their mean when `weights` is None (a
    full bucket), else sum(occ_i * w_i) / max(sum(w_i), 1) with w_i a
    shard's count of real samples (an int or a 0-dim tensor), so an
    all-pad shard weighs nothing."""
    dev = occs[0].device
    if weights is None:
        acc = occs[0]
        for o in occs[1:]:
            acc = acc + o.to(dev)
        return acc / len(occs)
    ws = [w.to(device=dev, dtype=torch.float32) if isinstance(w, torch.Tensor)
          else torch.full((), int(w), dtype=torch.float32, device=dev) for w in weights]
    num, den = occs[0] * ws[0], ws[0]
    for o, w in zip(occs[1:], ws[1:]):
        num = num + o.to(dev) * w
        den = den + w
    return num / den.clamp(min=1.0)


def run_plan_sharded(plan: PipelinePlan, params, imgs: torch.Tensor, mesh, *,
                     collect_occupancy: bool = False, n_valid=None):
    """`run_plan` data-parallel over a 1-D "data" mesh.

    Shard i runs rows [i*n/N, (i+1)*n/N) of the batch on slot i's device,
    with the params placed once per slot (`slot_params`) and its own
    per-sample (ids, cnt) schedules: sparsity skipping never needs another
    shard. Logits are gathered to slot 0 in shard order. With
    `collect_occupancy`, the shards' statistics are aggregated
    (`aggregate_occupancy`): the mean for a full batch, weighted by each
    shard's real samples when `n_valid` (the global count) is given.

    A shard's logits are bitwise `run_plan_unchecked` on its own slice; they
    equal the whole batch's rows where the convolutions are
    batch-invariant and the co-batched samples share a live-channel union
    (the engine's contract). `mesh=None` (or one slot) runs `run_plan`. The
    batch must divide the data axis: the batcher's device-aligned buckets
    guarantee it, and anything else raises. The plan is validated once, at
    the shard's batch."""
    if imgs.ndim == 3:
        imgs = imgs[None]
    if mesh is None or mesh.size == 1:
        return run_plan(plan, params, imgs, collect_occupancy=collect_occupancy,
                        n_valid=n_valid)
    rows = shard_rows(mesh, imgs.shape)
    validate_plan(plan, params, imgs[:rows])
    logits, occs, weights = [], [], []
    for i, dev in enumerate(mesh.slots):
        x = imgs[i * rows:(i + 1) * rows].to(dev)
        nv = None if n_valid is None else shard_n_valid(n_valid, i, rows, dev)
        out = run_plan_unchecked(plan, slot_params(params, mesh, dev), x,
                                 collect_occupancy=collect_occupancy, n_valid=nv)
        if collect_occupancy:
            out, occ = out
            occs.append(occ)
            weights.append(nv)
        logits.append(out)
    dev0 = logits[0].device
    logits = torch.cat([o.to(dev0) for o in logits])
    if collect_occupancy:
        return logits, aggregate_occupancy(occs, None if n_valid is None else weights)
    return logits
