"""CNN serving launcher on the port: single-image requests through the
sparsity-aware serving engine (dynamic batcher + plan cache + adaptive
re-planning) over a deterministic simulated-clock request stream that
carries real measured execution times (counterpart of
`repro.launch.serve_cnn`, steady traffic only).

`--prune-density D` block-prunes the weights to D (the planner may then put
layers on the BSR kernel); `--int8` lets the planner upgrade sparse and BSR
layers to the int8 kernels under the `--int8-budget` top-1 agreement.

Run on the card (default device "cuda"):
    PYTHONPATH=src python -m repro_torch.launch.serve_cnn --rate 50 --n-requests 24
    PYTHONPATH=src python -m repro_torch.launch.serve_cnn --model lenet --full
    PYTHONPATH=src python -m repro_torch.launch.serve_cnn --full --prune-density 0.3 --int8
On the host, through the kernels' plain PyTorch versions:
    PYTHONPATH=src python -m repro_torch.launch.serve_cnn --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_cnn --device cpu --prune-density 0.3 --int8 --n-requests 8
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


def serve_cnn(*, model: str = "vgg19", full: bool = False,
              n_requests: int = 24, rate: float = 50.0,
              max_batch: int = 8, deadline_ms: float = 10.0,
              occ_threshold: float = 0.75, block_c: int = 8,
              replan_band: float = 0.15, prune_density: float = 1.0,
              int8: bool = False, int8_budget: float = 0.98, seed: int = 0,
              device=None) -> dict:
    """Serve `n_requests` steady-rate requests of `model` and return the
    serving summary (plan, throughput and latency on the SimClock, cache
    counters)."""
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
    engine = Engine(params, graph=graph, calib=calib,
                    occ_threshold=occ_threshold, block_c=block_c,
                    max_batch=max_batch, deadline_s=deadline_ms * 1e-3,
                    clock=clock, replan_band=replan_band, int8=int8,
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
    results = replay_stream(engine, synth_requests(graph, n_requests, seed=seed + 2,
                                                   device=dev), rate_rps=rate)
    makespan = clock() - t_start
    lat_ms = np.array(sorted(r.latency_s for r in results)) * 1e3
    stats = engine.stats()
    summary = {
        "model": graph.name,
        "scenario": "steady",
        "device": str(dev),
        "plan": [f"{lp.impl}@{lp.occupancy:.2f}" for lp in engine.plan.layers],
        "prune_density": achieved_density,
        "plan_bsr": stats["plan_bsr"],
        "plan_int8": stats["plan_int8"],
        "requests": len(results),
        "rate_rps": rate,
        "throughput_rps": len(results) / max(makespan, 1e-9),
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p95_ms": float(np.percentile(lat_ms, 95)),
        "mean_fill": stats["mean_fill"],
        **{k: stats[k] for k in ("batches", "compiles", "hits", "replans")},
    }
    log.info("served %d requests at %.0f req/s offered: %.1f req/s, "
             "p50=%.1fms p95=%.1fms, %d batches (fill %.2f), %d builds / %d "
             "cache hits, %d replans", summary["requests"], rate,
             summary["throughput_rps"], summary["p50_ms"], summary["p95_ms"],
             summary["batches"], summary["mean_fill"], summary["compiles"],
             summary["hits"], summary["replans"])
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
    ap.add_argument("--prune-density", type=float, default=1.0,
                    help="block-prune the weights to this density (1.0 = no pruning)")
    ap.add_argument("--int8", action="store_true",
                    help="let the planner upgrade sparse/BSR layers to int8")
    ap.add_argument("--int8-budget", type=float, default=0.98,
                    help="top-1 agreement the int8 probe must keep")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the kernels' "
                         "plain PyTorch versions)")
    args = ap.parse_args()
    serve_cnn(model=args.model, full=args.full, n_requests=args.n_requests,
              rate=args.rate, max_batch=args.max_batch,
              deadline_ms=args.deadline_ms, occ_threshold=args.occ_threshold,
              block_c=args.block_c, prune_density=args.prune_density,
              int8=args.int8, int8_budget=args.int8_budget, seed=args.seed,
              device=args.device)


if __name__ == "__main__":
    main()
