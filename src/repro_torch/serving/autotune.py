"""Offline plan autotuner: search (occ_threshold, block_c) on a calibration
batch, select by measured wall time, fall back to the cost model when the
timing is too noisy (counterpart of `repro.serving.autotune`).

The planner's two knobs interact: a bigger `block_c` amortizes schedule
overhead but rounds the live blocks up harder (fewer skippable blocks), and
the profitable `occ_threshold` moves with both. The autotuner builds one
`PipelinePlan` per grid point (points that collapse to the same plan key
share one timing), times each distinct plan's compiled whole-batch runner
(`graph_runner.CompiledRunner`: one CUDA graph on the card, as the
reference times its jitted executor; the eager body on the CPU) through
`obs.profile.time_callable`, and picks the fastest.

The noisy-clock fallback ranks by `plan_model_us`, the registry's roofline
per layer, for every plan. The reference ranks all-dense plans by XLA's
HLO cost instead (`hlo_model_us`, through `launch/hlo_cost`); the port has
no HLO and `launch/hlo_cost` is not ported (ROADMAP queue 1, item 16), so
all-dense plans are modeled layer by layer like the others.

`mesh=` (a 1-D "data" mesh) times each candidate through the sharded
runner the serving engine would run (`graph_runner.ShardedRunner`); the
calibration batch must divide the mesh's slots. The model fallback stays
per device, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.graph import as_graph
from repro_torch.graph.registry import unit_model_us
from repro_torch.obs import constants
from repro_torch.pipeline.planner import PipelinePlan, plan_network
from repro_torch.serving.graph_runner import CompiledRunner, ShardedRunner
from repro_torch.serving.plan_cache import plan_key


@dataclass
class Candidate:
    occ_threshold: float
    block_c: int
    plan: PipelinePlan
    wall_us: float = float("inf")
    spread: float = 0.0  # (max-min)/median of the timing samples
    model_us: float = float("inf")
    timings_us: list = field(default_factory=list)

    def row(self) -> dict:
        return {"occ_threshold": self.occ_threshold, "block_c": self.block_c,
                "wall_us": round(self.wall_us, 1), "spread": round(self.spread, 3),
                "model_us": round(self.model_us, 3),
                "counts": self.plan.counts()}


@dataclass
class AutotuneResult:
    best: Candidate
    candidates: list
    used_model: bool  # True when the noisy-timing fallback decided the winner

    @property
    def plan(self) -> PipelinePlan:
        return self.best.plan


def plan_model_us(plan: PipelinePlan, params, batch: int = 1,
                  calibration=None) -> float:
    """Roofline-modeled time (us) of a plan at a batch size: the registry's
    `unit_model_us` per layer (at each LayerPlan's own specs, occupancy,
    weight density and tile) plus the classifier GEMMs.

    `calibration` (a `CalibrationDB`) prices each layer at its impl's
    measured constants; uncovered keys, and calibration=None, use the
    defaults. The head GEMMs always model at the defaults: they run outside
    the kernel families the DB is keyed on."""
    from repro_torch.graph.ir import graph_weights

    us = 0.0
    for lp in plan.layers:
        us += unit_model_us(lp.kind, lp.impl, lp.to_unit(),
                            occupancy=lp.occupancy,
                            weight_density=lp.weight_density, batch=batch,
                            block_c=plan.block_c, tile=lp.tile,
                            calibration=calibration)
    flops = 0.0
    nbytes = 0.0
    _, dense_ws = graph_weights(params)
    for w in dense_ws:
        d_in, d_out = w.shape
        flops += 2.0 * batch * d_in * d_out
        nbytes += 4.0 * (d_in * d_out + batch * (d_in + d_out))
    return us + constants.DEFAULT_ROOFLINE.time_us(flops, nbytes)


def _time_us(f, *args, iters: int = 3, warmup: int = 1) -> tuple:
    """(median_us, spread, samples) through the shared timing harness,
    outlier rejection off: the spread feeds the noisy-clock decision, which
    must see the raw clock quality."""
    from repro_torch.obs.profile import time_callable

    t = time_callable(f, *args, iters=iters, warmup=warmup, outlier_tol=0.0)
    return t.median_us, t.spread, list(t.samples_us)


def autotune(params, calib, graph=None, *,
             thresholds=(0.0, 0.5, 0.75, 0.9), block_cs=(0, 8),
             iters: int = 3, warmup: int = 1, noise_tol: float = 0.25,
             use_pallas: bool = True, mode: str = "auto", mesh=None, calibration=None,
             tiles=None, int8: bool = False, int8_budget: float = 0.98) -> AutotuneResult:
    """Grid-search (occ_threshold, block_c); return the plan that serves the
    calibration batch fastest. `graph` is a LayerGraph or CNNConfig (None =
    VGG-19).

    mode="auto" selects by median wall time, unless the timing cannot
    separate the top two distinct plans (the winner's spread exceeds
    `noise_tol`, or the runner-up is within the larger of the two spreads);
    then the ranking falls back to `plan_model_us`. mode="time" /
    mode="model" force one criterion.

    `use_pallas`, `calibration`, `tiles`, `int8` and `int8_budget` pass
    through to `plan_network`, so the search ranks the plans that would serve; the
    model fallback prices them through `calibration` too. `mesh` times the
    candidates data-parallel (module docstring); a one-slot mesh is None.
    """
    graph = as_graph(graph)
    if calib.ndim == 3:
        calib = calib[None]
    if mesh is not None and mesh.size == 1:
        mesh = None
    seen: dict = {}
    cands: list = []
    for th in thresholds:
        for bc in block_cs:
            plan = plan_network(params, calib, graph, occ_threshold=th,
                                block_c=bc, use_pallas=use_pallas,
                                calibration=calibration, tiles=tiles,
                                int8=int8, int8_budget=int8_budget)
            sig = plan_key(calib.shape[0], plan)
            if sig in seen:  # same plan key == same runner: reuse the timing
                cands.append(Candidate(th, bc, plan, *seen[sig]))
                continue
            if mode == "model":  # ranking by model only: skip the timing runs
                wall, spread, ts = float("inf"), 0.0, []
            else:
                runner = CompiledRunner(plan, params, calib.shape[0], calib.device) \
                    if mesh is None else ShardedRunner(plan, params, calib.shape[0], mesh)
                try:
                    wall, spread, ts = _time_us(
                        lambda p, x, r=runner: r(p, x, x.shape[0]), params, calib,
                        iters=iters, warmup=warmup)
                finally:
                    runner.release()
            seen[sig] = (wall, spread, float("inf"), ts)
            cands.append(Candidate(th, bc, plan, wall, spread, float("inf"), ts))
    by_time = sorted(cands, key=lambda c: c.wall_us)
    # distinct plans only: aliases share one timing, and comparing the
    # winner against its own alias would read as margin 0, "noisy"
    uniq: dict = {}
    for c in by_time:
        uniq.setdefault(plan_key(calib.shape[0], c.plan), c)
    distinct = list(uniq.values())
    used_model = mode == "model"
    if mode == "auto" and len(distinct) > 1:
        w0, w1 = distinct[0], distinct[1]
        margin = (w1.wall_us - w0.wall_us) / max(w0.wall_us, 1e-9)
        used_model = w0.spread > noise_tol or margin < max(w0.spread, w1.spread)
    elif mode == "auto":
        used_model = distinct[0].spread > noise_tol
    if used_model:
        model_by_sig: dict = {}
        for c in cands:
            sig = plan_key(calib.shape[0], c.plan)
            if sig not in model_by_sig:
                model_by_sig[sig] = plan_model_us(c.plan, params,
                                                  batch=calib.shape[0],
                                                  calibration=calibration)
            c.model_us = model_by_sig[sig]
    best = min(cands, key=lambda c: c.model_us) if used_model else by_time[0]
    return AutotuneResult(best=best, candidates=cands, used_model=used_model)
