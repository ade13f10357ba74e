"""CNN serving launcher on the port: single-image requests through the
sparsity-aware serving engine (dynamic batcher + plan cache + adaptive
re-planning) over a deterministic simulated-clock request stream that
carries real measured execution times (counterpart of
`repro.launch.serve_cnn`).

`--prune-density D` block-prunes the weights to D (the planner may then put
layers on the BSR kernel); `--int8` lets the planner upgrade sparse and BSR
layers to the int8 kernels under the `--int8-budget` top-1 agreement.
`--calibrate` profiles the base plan per layer and impl and fits measured
cost constants; `--tile-search` searches each layer's kernel geometry and
serves the winners; `--calib-out` saves that CalibrationDB as JSON (the
reference's `calibration-v2` schema); `--autotune` searches
(occ_threshold, block_c); `--trace-out` writes a Chrome trace of the run.
`--scenario` picks the traffic regime: a steady stream (default), Poisson
bursts, a diurnal occupancy step (forces a re-plan), a hot swap to a
0.3-density pruned variant at the stream's midpoint, or two models
multi-tenant over one plan cache. `--history DB` ingests the serving summary
and telemetry snapshot (and any fitted calibration) into the perf-history
BenchDB, which `python -m repro_torch.obs.history.cli` reads.

Run on the card (default device "cuda"):
    PYTHONPATH=src python -m repro_torch.launch.serve_cnn --rate 50 --n-requests 24
    PYTHONPATH=src python -m repro_torch.launch.serve_cnn --model lenet --full
    PYTHONPATH=src python -m repro_torch.launch.serve_cnn --full --prune-density 0.3 --int8
    PYTHONPATH=src python -m repro_torch.launch.serve_cnn --full --scenario hotswap --history benchdb.jsonl
On the host, through the kernels' plain PyTorch versions:
    PYTHONPATH=src python -m repro_torch.launch.serve_cnn --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_cnn --device cpu --prune-density 0.3 --int8 --n-requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve_cnn --device cpu --calibrate --tile-search --autotune --trace-out t.json --calib-out cal.json --n-requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve_cnn --device cpu --scenario diurnal --n-requests 16 --rate 100
    PYTHONPATH=src python -m repro_torch.launch.serve_cnn --device cpu --scenario hotswap --n-requests 16 --rate 100 --history benchdb.jsonl
"""
from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from repro_torch.configs.vgg19_sparse import CNNConfig, vgg19_graph
from repro_torch.core.sparsity import dead_channel_band
from repro_torch.device import resolve_device
from repro_torch.graph import LayerGraph, as_graph, init_graph
from repro_torch.models.cnn import shift_dead_channels
from repro_torch.serving import Engine, SimClock, replay_stream

log = logging.getLogger("repro_torch.serve_cnn")

MODELS = ("vgg19", "lenet", "alexnet")
SCENARIOS = ("steady", "burst", "diurnal", "hotswap", "multitenant")


def serving_graph(model: str = "vgg19", full: bool = False) -> LayerGraph:
    """Reduced: stacks the CPU tests serve in seconds. Full: the real network
    depth (VGG at 96 px, the reference's serving size; the published 224 px
    VGG-19 is `vgg19_graph(CNNConfig())`)."""
    if model == "lenet":
        from repro_torch.configs.lenet import LENET, LENET_REDUCED

        return LENET if full else LENET_REDUCED
    if model == "alexnet":
        from repro_torch.configs.alexnet import ALEXNET, ALEXNET_REDUCED

        return ALEXNET if full else ALEXNET_REDUCED
    if model != "vgg19":
        raise ValueError(f"unknown --model {model!r} (choose from {MODELS})")
    if full:
        return vgg19_graph(CNNConfig(img_size=96))
    return vgg19_graph(CNNConfig(name="vgg-tiny", in_channels=16, img_size=16,
                                 plan=((16, 2), (32, 1)), n_classes=16))


def synth_requests(graph, n: int, seed: int = 0, dead_frac: float = 0.5,
                   device=None) -> list:
    """Single-image requests, uniform in [0, 1) from a `torch.Generator`
    seeded per request, with a shared trailing dead-channel band (the
    trained-net activation statistic the planner exploits)."""
    dev = resolve_device(device)
    shape = as_graph(graph).in_shape
    return [dead_channel_band(
        torch.rand(shape, generator=torch.Generator().manual_seed(seed * 1000 + i)),
        dead_frac).to(dev) for i in range(n)]


def _scenario_setup(scenario, model, engine, *, full, n_requests, rate, seed):
    """The non-steady traffic regimes: returns the scenario and the {stream:
    Engine} map `replay_scenario` drives. Every regime is timed off the
    stream's midpoint, so its event (burst cycle, drift onset, swap) lands
    while requests still flow."""
    from repro_torch.serving import (
        DiurnalDriftScenario,
        HotSwapScenario,
        MultiTenantScenario,
        PoissonBurstScenario,
        TenantSpec,
    )

    shape = engine.graph.in_shape
    t_mid = n_requests / (2.0 * rate)
    if scenario == "burst":
        return PoissonBurstScenario(
            in_shape=shape, n_requests=n_requests, base_rps=rate,
            burst_rps=rate * 16, burst_every_s=t_mid,
            burst_len_s=t_mid / 4, seed=seed), {"": engine}
    if scenario == "diurnal":
        return DiurnalDriftScenario(
            in_shape=shape, n_requests=n_requests, rate_rps=rate,
            dead_lo=0.5, dead_hi=0.0, drift="step", t_drift=t_mid,
            seed=seed), {"": engine}
    if scenario == "hotswap":
        from repro_torch.sparse_weights.prune import prune_graph_params

        pruned, report = prune_graph_params(engine.params, 0.3, engine.graph)
        log.info("hot-swap variant: pruned to %.2f achieved block density",
                 report.density)

        def swap(engines):
            engines[""].hot_swap(pruned)

        return HotSwapScenario(
            in_shape=shape, n_requests=n_requests, rate_rps=rate,
            t_swap=t_mid, swap_fn=swap, seed=seed), {"": engine}
    if scenario == "multitenant":
        other = "lenet" if model != "lenet" else "vgg19"
        graph2 = serving_graph(other, full)
        params2 = shift_dead_channels(init_graph(
            torch.Generator().manual_seed(seed + 1), graph2, device=engine.device))
        calib2 = torch.stack(synth_requests(graph2, 2, seed=seed + 3,
                                            device=engine.device))
        # the second tenant shares the first's clock and PlanCache: the
        # PlanKey graph / weight signatures keep the runners apart
        engine2 = Engine(params2, graph=graph2, calib=calib2,
                         occ_threshold=engine.plan.occ_threshold,
                         block_c=engine.plan.block_c,
                         max_batch=engine.batcher.max_batch,
                         deadline_s=engine.batcher.deadline_s,
                         clock=engine.clock, cache=engine.cache,
                         device=engine.device)
        engine2.warmup()
        tenants = ((model, TenantSpec(in_shape=shape,
                                      n_requests=n_requests // 2,
                                      rate_rps=rate)),
                   (other, TenantSpec(in_shape=graph2.in_shape,
                                      n_requests=n_requests // 2,
                                      rate_rps=rate)))
        return MultiTenantScenario(tenants=tenants, seed=seed), \
            {model: engine, other: engine2}
    raise ValueError(f"unknown --scenario {scenario!r} "
                     f"(choose from {SCENARIOS})")


def serve_cnn(*, model: str = "vgg19", full: bool = False,
              n_requests: int = 24, rate: float = 50.0,
              max_batch: int = 8, deadline_ms: float = 10.0,
              occ_threshold: float = 0.75, block_c: int = 8,
              replan_band: float = 0.15, prune_density: float = 1.0,
              int8: bool = False, int8_budget: float = 0.98, seed: int = 0,
              do_autotune: bool = False, trace_out: str | None = None,
              calibrate: bool = False, calib_out: str | None = None,
              tile_search: bool = False, scenario: str = "steady",
              history: str | None = None, device=None) -> dict:
    """Serve `n_requests` requests of `model` under the `scenario` traffic
    regime and return the serving summary (plan, throughput and latency on
    the SimClock, cache counters). `calibrate`, `tile_search`,
    `do_autotune`, `calib_out` and `trace_out` run the measure -> calibrate
    -> search -> plan loop before serving; `history` ingests the summary
    into that BenchDB (see the module docstring)."""
    dev = resolve_device(device)
    graph = serving_graph(model, full)
    params = shift_dead_channels(init_graph(torch.Generator().manual_seed(seed),
                                            graph, device=dev))
    calib = torch.stack(synth_requests(graph, 2, seed=seed + 1, device=dev))
    achieved_density = 1.0
    if prune_density < 1.0:
        from repro_torch.sparse_weights.prune import prune_graph_params

        params, report = prune_graph_params(params, prune_density, graph,
                                            probe=calib)
        achieved_density = report.density
        log.info("pruned to %.2f achieved block density (target %.2f): "
                 "max logit drift %.3g, top-1 agreement %.2f",
                 report.density, prune_density, report.max_logit_drift,
                 report.top1_agreement)
    clock = SimClock()
    tracer = None
    if trace_out:
        from repro_torch.obs import Tracer

        # the tracer shares the engine's SimClock, so two identical runs
        # export the same trace (the measured spans are wall time)
        tracer = Tracer(clock=clock)
    calibration = None
    if calibrate:
        from repro_torch.obs import CalibrationDB, profile_plan
        from repro_torch.pipeline import plan_network

        # time the default-constants plan, fit effective constants from the
        # measured/modeled ratios, then plan everything after with them
        base = plan_network(params, calib, graph, occ_threshold=occ_threshold,
                            block_c=block_c)
        report = profile_plan(base, params, calib, tracer=tracer)
        calibration = CalibrationDB.from_report(report)
        log.info("calibrated %d (kind, impl) keys on %s: %s",
                 len(calibration.entries), calibration.device,
                 calibration.summary())
    tiles = None
    if tile_search:
        from repro_torch.obs import tile_search as run_tile_search
        from repro_torch.pipeline import plan_network

        # search every layer the occupancy rule sends to a kernel, at its
        # planned impl (the calibrated planner then weighs each kernel at its
        # searched geometry against the dense path); winners land in the
        # calibration DB's tiles table, shared with --calibrate
        base = plan_network(params, calib, graph, occ_threshold=occ_threshold,
                            block_c=block_c)
        ts_report, tiles = run_tile_search(base, params, calib, db=calibration,
                                           calibration=calibration,
                                           tracer=tracer)
        if calibration is None:
            calibration = tiles  # the per-tile fits double as constants
        log.info("tile search: %d/%d layers improved on defaults "
                 "(modeled speedup %.3fx, floor holds: %s)",
                 len(ts_report.improved_layers()), len(ts_report.layers),
                 ts_report.summary()["model_speedup"],
                 ts_report.floor_holds())
    if calib_out and calibration is not None:
        calibration.save(calib_out)
        log.info("calibration DB written to %s", calib_out)
    plan = None
    if do_autotune:
        from repro_torch.serving import autotune

        from repro_torch.obs import NULL_TRACER

        with (tracer or NULL_TRACER).span("plan", graph=graph.name, autotune=True):
            result = autotune(params, calib, graph, thresholds=(0.5, 0.75, 0.9),
                              block_cs=(0, 8), calibration=calibration,
                              tiles=tiles, int8=int8, int8_budget=int8_budget)
        plan = result.plan
        log.info("autotune picked occ_threshold=%.2f block_c=%d (model "
                 "fallback: %s)", result.best.occ_threshold,
                 result.best.block_c, result.used_model)
    engine = Engine(params, graph=graph, plan=plan, calib=calib,
                    occ_threshold=occ_threshold, block_c=block_c,
                    max_batch=max_batch, deadline_s=deadline_ms * 1e-3,
                    clock=clock, replan_band=replan_band, tracer=tracer,
                    calibration=calibration, tiles=tiles, int8=int8,
                    int8_budget=int8_budget, device=dev)
    rep8 = engine.plan.int8_report
    if rep8 is not None:
        log.info("int8 probe: %d layers quantized (%d demoted), top-1 "
                 "agreement %.3f, max logit drift %.3g",
                 len(rep8.layers), len(rep8.demoted), rep8.top1_agreement,
                 rep8.max_logit_drift)
    log.info("%s plan: %s", graph.name, " ".join(
        f"conv{lp.index + 1}={lp.impl}@{lp.occupancy:.2f}" for lp in engine.plan.layers))
    built = engine.warmup()
    log.info("built %d bucket runners (buckets=%s)", built,
             engine.batcher.exec_buckets())
    t_start = clock()
    if scenario == "steady":
        results = replay_stream(engine, synth_requests(graph, n_requests, seed=seed + 2,
                                                       device=dev), rate_rps=rate)
    else:
        from repro_torch.serving import replay_scenario

        scn, engines = _scenario_setup(scenario, model, engine, full=full,
                                       n_requests=n_requests, rate=rate, seed=seed)
        results = [r for out in replay_scenario(engines, scn).values() for r in out]
    makespan = clock() - t_start
    lat_ms = np.array(sorted(r.latency_s for r in results)) * 1e3
    stats = engine.stats()
    summary = {
        "model": graph.name,
        "scenario": scenario,
        "device": str(dev),
        "plan": [f"{lp.impl}@{lp.occupancy:.2f}" for lp in engine.plan.layers],
        "prune_density": achieved_density,
        "plan_bsr": stats["plan_bsr"],
        "plan_int8": stats["plan_int8"],
        "plan_tiled": stats["plan_tiled"],
        "requests": len(results),
        "rate_rps": rate,
        "throughput_rps": len(results) / max(makespan, 1e-9),
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p95_ms": float(np.percentile(lat_ms, 95)),
        "mean_fill": stats["mean_fill"],
        **{k: stats[k] for k in ("batches", "compiles", "hits", "replans",
                                 "hot_swaps")},
        "calibrated": 0 if calibration is None else len(calibration.entries),
    }
    if tracer is not None:
        tracer.save(trace_out)
        log.info("wrote %d trace events to %s (chrome://tracing / Perfetto)",
                 len(tracer.events), trace_out)
    if history:
        from repro_torch.obs.history import (
            BenchDB,
            calibration_rows,
            make_payload,
            telemetry_rows,
        )

        db = BenchDB(history)
        # the scalar serving summary, the engine's telemetry snapshot and
        # the fitted calibration scales (when this run fitted one)
        rows = [{"name": f"serve/{graph.name}/{scenario}",
                 **{k: v for k, v in summary.items()
                    if isinstance(v, (int, float)) and not isinstance(v, bool)}}]
        rows += telemetry_rows(stats["telemetry"],
                               prefix=f"telemetry/{graph.name}/{scenario}")
        if calibration is not None:
            rows += calibration_rows(calibration)
        n_new = db.ingest_payload(make_payload("serve_cnn", rows, device=dev))
        log.info("perf history: %d point(s) ingested into %s "
                 "(%d total, %d series)", n_new, history, len(db),
                 len(db.series()))
    log.info("served %d requests (%s traffic) at %.0f req/s offered: "
             "%.1f req/s, p50=%.1fms p95=%.1fms, %d batches (fill %.2f), "
             "%d builds / %d cache hits, %d replans, %d hot swaps",
             summary["requests"], scenario, rate, summary["throughput_rps"],
             summary["p50_ms"], summary["p95_ms"], summary["batches"],
             summary["mean_fill"], summary["compiles"], summary["hits"],
             summary["replans"], summary["hot_swaps"])
    return summary


def main():
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", choices=MODELS, default="vgg19",
                    help="which LayerGraph network to serve")
    ap.add_argument("--full", action="store_true", help="full network depth")
    ap.add_argument("--n-requests", type=int, default=24)
    ap.add_argument("--rate", type=float, default=50.0, help="offered request rate (req/s)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--deadline-ms", type=float, default=10.0)
    ap.add_argument("--occ-threshold", type=float, default=0.75)
    ap.add_argument("--block-c", type=int, default=8,
                    help="channel-block size of the schedules (0 = auto)")
    ap.add_argument("--replan-band", type=float, default=0.15,
                    help="occupancy-EMA hysteresis band around the plan's "
                         "calibrated occupancies; drift beyond it re-plans")
    ap.add_argument("--prune-density", type=float, default=1.0,
                    help="block-prune the weights to this density (1.0 = no pruning)")
    ap.add_argument("--int8", action="store_true",
                    help="let the planner upgrade sparse/BSR layers to int8")
    ap.add_argument("--int8-budget", type=float, default=0.98,
                    help="top-1 agreement the int8 probe must keep")
    ap.add_argument("--autotune", action="store_true",
                    help="search (occ_threshold, block_c) on the calibration "
                         "batch and serve the fastest plan")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace_event JSON of the run (plan, "
                         "compile, execute, profile and tile-search spans)")
    ap.add_argument("--calibrate", action="store_true",
                    help="profile the base plan per layer and impl, fit a "
                         "CalibrationDB of measured roofline constants, and "
                         "plan the served engine with it")
    ap.add_argument("--calib-out", default=None, metavar="PATH",
                    help="with --calibrate / --tile-search: save the "
                         "CalibrationDB (constants and tile winners) as JSON")
    ap.add_argument("--tile-search", action="store_true",
                    help="search each planned layer's kernel tile geometry "
                         "and serve with the measured-best winners")
    ap.add_argument("--scenario", choices=SCENARIOS, default="steady",
                    help="traffic regime: steady open-loop stream (default), "
                         "Poisson bursts, diurnal occupancy drift (forces a "
                         "re-plan), hot swap to a 0.3-density pruned variant "
                         "mid-stream, or two models multi-tenant over one "
                         "shared plan cache")
    ap.add_argument("--history", default=None, metavar="DB",
                    help="perf-history BenchDB (JSONL): ingest this run's "
                         "serving summary and telemetry snapshot as cross-run "
                         "series for python -m repro_torch.obs.history.cli")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the kernels' "
                         "plain PyTorch versions)")
    args = ap.parse_args()
    serve_cnn(model=args.model, full=args.full, n_requests=args.n_requests,
              rate=args.rate, max_batch=args.max_batch,
              deadline_ms=args.deadline_ms, occ_threshold=args.occ_threshold,
              block_c=args.block_c, replan_band=args.replan_band,
              prune_density=args.prune_density,
              int8=args.int8, int8_budget=args.int8_budget, seed=args.seed,
              do_autotune=args.autotune, trace_out=args.trace_out,
              calibrate=args.calibrate, calib_out=args.calib_out,
              tile_search=args.tile_search, scenario=args.scenario,
              history=args.history, device=args.device)


if __name__ == "__main__":
    main()
