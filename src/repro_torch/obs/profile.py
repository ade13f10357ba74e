"""Per-layer timing harness: measured against roofline-modeled time per impl
(counterpart of `repro.obs.profile`).

- `time_callable` is the one wall-time harness: warm-up calls, a device
  barrier after every call, median-of-k with outlier rejection. The serving
  autotuner and the tile search time through it too, so their numbers and
  the profile rows are comparable.
- `profile_plan` walks a `PipelinePlan`'s layers at their real shapes (the
  dense-oracle walk `plan_network` calibrates with), times each layer's
  forward under every requested impl, and pairs each measurement with the
  registry's modeled cost: one `LayerTiming` per (layer, kind, impl).
- `ProfileReport` aggregates them: per-(kind, impl) predicted/measured
  ratios (the `CalibrationDB` fit input), ranking agreement (does the model
  order the impls the way the clock does?), and `recalibrated(db)`, which
  re-predicts every row through a fitted DB.

On the card a sample is the host wall around the call and a
`torch.cuda.synchronize`, so it includes the host's launch overhead; on the
host the kernels run their plain PyTorch versions, so a CPU profile says
nothing about the card.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace

import torch

# default impl panel: the four conv families the planner arbitrates between
# (fused-family names resolve per unit through the registry's unit_impl rule)
PROFILE_IMPLS = ("dense", "ecr_pallas", "pecr_pallas", "bsr")


@dataclass(frozen=True)
class TimingResult:
    """One timed callable: median of the kept samples after outlier
    rejection; spread = (max-min)/median over the kept samples."""

    median_us: float
    spread: float
    samples_us: tuple
    rejected: int = 0


def _barrier(out) -> None:
    """Wait for the device that holds `out` (a tensor, or a tuple or list
    whose first tensor decides); a host result needs no wait."""
    if isinstance(out, (tuple, list)):
        out = next((o for o in out if isinstance(o, torch.Tensor)), None)
    if isinstance(out, torch.Tensor) and out.device.type == "cuda":
        torch.cuda.synchronize(out.device)


def time_callable(f, *args, iters: int = 3, warmup: int = 1,
                  outlier_tol: float = 0.0) -> TimingResult:
    """Median wall time of `f(*args)`: `warmup` untimed calls, every call
    followed by a barrier on the device of its output (PyTorch returns
    before the card finishes, so an unbarriered sample would time the
    enqueue), and with `outlier_tol > 0` samples farther than
    `outlier_tol x median` from the median dropped before the median is
    taken again."""
    for _ in range(warmup):
        _barrier(f(*args))
    ts = []
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        _barrier(f(*args))
        ts.append((time.perf_counter() - t0) * 1e6)
    med = _median(ts)
    kept = ts
    if outlier_tol > 0.0 and len(ts) > 2:
        lo, hi = med / (1.0 + outlier_tol), med * (1.0 + outlier_tol)
        kept = [t for t in ts if lo <= t <= hi] or ts
        med = _median(kept)
    spread = (max(kept) - min(kept)) / max(med, 1e-9)
    return TimingResult(median_us=float(med), spread=float(spread),
                        samples_us=tuple(float(t) for t in ts),
                        rejected=len(ts) - len(kept))


def _median(vals) -> float:
    s = sorted(vals)
    n = len(s)
    return float(s[n // 2]) if n % 2 else float((s[n // 2 - 1] + s[n // 2]) / 2)


@dataclass(frozen=True)
class LayerTiming:
    """One (layer, kind, impl) measurement next to its model prediction."""

    index: int  # conv index in network order
    kind: str
    impl: str
    occupancy: float  # measured channel-block occupancy of the layer input
    weight_density: float  # measured BSR block density of the layer's params
    batch: int
    block_c: int
    measured_us: float
    spread: float
    predicted_us: float  # unit_model_us at the default constants
    flops: float  # the registry's modeled cost (the calibration fit input)
    bytes: float
    tile: tuple = ()  # TileConfig.key() when timed at a searched geometry

    @property
    def ratio(self) -> float:
        """predicted / measured: the per-row cost-model error whose median
        the CalibrationDB fits per impl."""
        return self.predicted_us / max(self.measured_us, 1e-9)

    def row(self) -> dict:
        return {"layer": self.index, "kind": self.kind, "impl": self.impl,
                "tile": list(self.tile),
                "occupancy": round(self.occupancy, 4),
                "weight_density": round(self.weight_density, 4),
                "measured_us": round(self.measured_us, 2),
                "predicted_us": round(self.predicted_us, 4),
                "ratio": round(self.ratio, 6), "spread": round(self.spread, 3)}


@dataclass(frozen=True)
class ProfileReport:
    """All `LayerTiming`s of one `profile_plan` run, plus each layer's
    ConvUnit (`units`), so a fitted CalibrationDB can re-predict the rows
    without timing them again."""

    graph_name: str
    device_kind: str
    batch: int
    block_c: int
    timings: tuple  # tuple[LayerTiming, ...]
    units: tuple = field(default=(), repr=False)  # ConvUnit per conv index

    def by_impl(self) -> dict:
        """{(kind, impl): [LayerTiming, ...]}: the calibration fit groups."""
        groups: dict = {}
        for t in self.timings:
            groups.setdefault((t.kind, t.impl), []).append(t)
        return groups

    def layers(self) -> dict:
        """{conv index: [LayerTiming, ...]}: the ranking-agreement groups."""
        out: dict = {}
        for t in self.timings:
            out.setdefault(t.index, []).append(t)
        return out

    def agreement(self) -> dict:
        """How well the model orders impls the way the clock does, over the
        layers that profiled >= 2 impls: "top1" is the fraction of layers
        whose modeled-fastest impl is also the measured-fastest, "pairwise"
        the fraction of impl pairs per layer ordered alike, "layers" how
        many layers counted."""
        top1 = pair_hits = pair_total = n = 0
        for rows in self.layers().values():
            if len(rows) < 2:
                continue
            n += 1
            meas = sorted(rows, key=lambda t: t.measured_us)
            pred = sorted(rows, key=lambda t: t.predicted_us)
            top1 += (meas[0].kind, meas[0].impl) == (pred[0].kind, pred[0].impl)
            for i in range(len(rows)):
                for j in range(i + 1, len(rows)):
                    a, b = rows[i], rows[j]
                    pair_total += 1
                    pair_hits += ((a.measured_us < b.measured_us)
                                  == (a.predicted_us < b.predicted_us))
        return {"top1": top1 / n if n else 0.0,
                "pairwise": pair_hits / pair_total if pair_total else 0.0,
                "layers": n}

    def recalibrated(self, calibration) -> "ProfileReport":
        """The same measurements with `predicted_us` re-derived through a
        `CalibrationDB`: agreement() on the result scores the calibrated
        cost model."""
        from repro_torch.graph.registry import unit_model_us
        from repro_torch.kernels.tiles import TileConfig

        unit_by_index = {u.index: u for u in self.units}
        rows = []
        for t in self.timings:
            tile = TileConfig.from_key(t.tile) if t.tile else None
            pred = unit_model_us(
                t.kind, t.impl, unit_by_index[t.index], occupancy=t.occupancy,
                weight_density=t.weight_density, batch=t.batch,
                block_c=t.block_c, tile=tile, calibration=calibration)
            rows.append(replace(t, predicted_us=pred))
        return replace(self, timings=tuple(rows))

    def history_rows(self) -> list:
        """This report as perf-history rows (per-impl ratio medians and the
        ranking agreement): `obs.history.profile_rows(self)`."""
        from repro_torch.obs.history.records import profile_rows

        return profile_rows(self)

    def summary(self) -> dict:
        """JSON-ready digest for `Engine.stats()["telemetry"]["profile"]`."""
        per_impl = {}
        for (kind, impl), rows in sorted(self.by_impl().items()):
            ratios = sorted(t.ratio for t in rows)
            per_impl[f"{kind}/{impl}"] = {
                "layers": len(rows),
                "measured_us_total": round(sum(t.measured_us for t in rows), 2),
                "ratio_median": round(_median(ratios), 6),
            }
        return {"graph": self.graph_name, "device_kind": self.device_kind,
                "batch": self.batch, "block_c": self.block_c,
                "per_impl": per_impl, "agreement": self.agreement(),
                "rows": [t.row() for t in self.timings]}


def profile_plan(plan, params, calib, *, impls=PROFILE_IMPLS, iters: int = 3,
                 warmup: int = 1, outlier_tol: float = 2.0,
                 tracer=None) -> ProfileReport:
    """Time every layer of `plan` at its real shapes under each impl family.

    Walks the plan's graph on `calib` with the dense oracle (each layer is
    timed on the input the planner measured), resolves each requested impl
    family against the unit's structure (fused families land on
    fusion-eligible units through the registry's `unit_impl`, their conv
    fallback elsewhere; duplicates after resolution are timed once), and
    times the whole-batch `run_unit` through `time_callable`. Each
    measurement is paired with `unit_model_us` at the default constants;
    `CalibrationDB.from_report` fits measured ones from the report.

    `tracer` gets one "profile_layer" span per (layer, impl) inside a
    "profile" span.
    """
    from repro_torch.graph.executor import run_unit
    from repro_torch.graph.ir import graph_weights
    from repro_torch.graph.registry import unit_cost, unit_impl, unit_model_us
    from repro_torch.obs.calibrate import device_kind
    from repro_torch.obs.trace import NULL_TRACER
    from repro_torch.pipeline.planner import measure_occupancy
    from repro_torch.sparse_weights.format import weight_block_density

    tracer = tracer or NULL_TRACER
    graph = plan.graph
    if calib.ndim == 3:
        calib = calib[None]
    batch = int(calib.shape[0])
    conv_ws, _ = graph_weights(params)
    timings: list = []
    units = tuple(graph.units())
    x = calib
    with tracer.span("profile", graph=graph.name, batch=batch):
        for unit, w in zip(units, conv_ws):
            occ = measure_occupancy(x, plan.block_c)
            wd = weight_block_density(w)
            seen: set = set()
            for family in impls:
                kind, impl = unit_impl(unit, family)
                if (kind, impl) in seen:
                    continue
                seen.add((kind, impl))

                def fwd(x_, w_, unit=unit, kind=kind, impl=impl):
                    return run_unit(x_, w_, unit, kind, impl, plan.block_c)

                with tracer.span("profile_layer", cat="kernel",
                                 layer=unit.index, kind=kind, impl=impl):
                    t = time_callable(fwd, x, w, iters=iters, warmup=warmup,
                                      outlier_tol=outlier_tol)
                conv = unit.conv
                c, h, wdt = unit.in_shape
                cost = unit_cost(
                    kind, impl, c=c, h=h + 2 * conv.pad, w=wdt + 2 * conv.pad,
                    o=conv.c_out, k=conv.k, stride=conv.stride,
                    pool=unit.pool.p if unit.pool is not None else None,
                    occupancy=occ, weight_density=wd, batch=batch)
                timings.append(LayerTiming(
                    index=unit.index, kind=kind, impl=impl, occupancy=occ,
                    weight_density=wd, batch=batch, block_c=plan.block_c,
                    measured_us=t.median_us, spread=t.spread,
                    predicted_us=unit_model_us(
                        kind, impl, unit, occupancy=occ, weight_density=wd,
                        batch=batch, block_c=plan.block_c),
                    flops=float(cost["flops"]), bytes=float(cost["bytes"])))
            x = run_unit(x, w, unit, "conv", "dense")  # next layer's input
    return ProfileReport(graph_name=graph.name, device_kind=device_kind(calib.device),
                         batch=batch, block_c=plan.block_c,
                         timings=tuple(timings), units=units)
