"""Sweep the port's model zoo through the static verifier (counterpart of
`repro.analysis.cli`).

For each selected model this mirrors the serving launcher's set-up (the same
graphs, the same synthetic dead-channel calibration batch, the same pruning
path), plans the network and verifies the plan and params without serving
anything. The exit status is nonzero iff an error-severity diagnostic fires.

Run on the card (default), or on the host with --device cpu:
    PYTHONPATH=src python -m repro_torch.analysis.cli --model lenet
    PYTHONPATH=src python -m repro_torch.analysis.cli --device cpu --model all --prune-density 0.3 --int8 --json
    PYTHONPATH=src python -m repro_torch.analysis.cli --device cpu --dead-imports
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.deadcode import check_dead_imports
from repro_torch.analysis.diagnostics import (
    DiagnosticSink,
    errors,
    format_diagnostics,
    sort_diagnostics,
)
from repro_torch.analysis.verify import PlanVerificationError, verify_plan


def lint_model(model: str, *, full: bool = False, prune_density: float = 1.0,
               int8: bool = False, occ_threshold: float = 0.75,
               block_c: int = 0, seed: int = 0, device=None) -> dict:
    """Plan one zoo model the way `serve_cnn` would and verify the result.
    Returns {"model", "plan", "diagnostics"} (Diagnostic objects)."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.graph import init_graph
    from repro_torch.launch.serve_cnn import serving_graph, synth_requests
    from repro_torch.models.cnn import shift_dead_channels
    from repro_torch.pipeline.planner import plan_network

    dev = resolve_device(device)
    graph = serving_graph(model, full)
    params = shift_dead_channels(init_graph(torch.Generator().manual_seed(seed),
                                            graph, device=dev))
    calib = torch.stack(synth_requests(graph, 2, seed=seed + 1, device=dev))
    if prune_density < 1.0:
        from repro_torch.sparse_weights.prune import prune_graph_params

        params, _ = prune_graph_params(params, prune_density, graph, probe=calib)
    try:
        plan = plan_network(params, calib, graph, occ_threshold=occ_threshold,
                            block_c=block_c, int8=int8)
    except PlanVerificationError as e:
        # plan_network verifies before returning: report its findings and
        # go on with the sweep
        return {"model": graph.name, "plan": None,
                "diagnostics": list(e.diagnostics)}
    diags = verify_plan(plan, params, batch=int(calib.shape[0]))
    return {"model": graph.name,
            "plan": {"layers": [f"{lp.kind}/{lp.impl}" for lp in plan.layers],
                     **plan.counts()},
            "diagnostics": diags}


def main(argv=None) -> int:
    from repro_torch.launch.serve_cnn import MODELS

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.cli", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", choices=MODELS + ("all",), default="all",
                    help="which zoo model to lint (default: the whole zoo)")
    ap.add_argument("--full", action="store_true",
                    help="full network depth (slow on the host)")
    ap.add_argument("--prune-density", type=float, default=1.0,
                    help="block-prune to this density before planning "
                         "(1.0 = no pruning)")
    ap.add_argument("--int8", action="store_true",
                    help="plan with int8 upgrades (probed, as in serving)")
    ap.add_argument("--occ-threshold", type=float, default=0.75)
    ap.add_argument("--block-c", type=int, default=0,
                    help="channel-block size (0 = auto)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where to plan (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--dead-imports", action="store_true",
                    help="also report modules unreachable from the CNN "
                         "spine (RPA901, info)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output (one JSON document)")
    args = ap.parse_args(argv)

    models = MODELS if args.model == "all" else (args.model,)
    reports = [lint_model(m, full=args.full, prune_density=args.prune_density,
                          int8=args.int8, occ_threshold=args.occ_threshold,
                          block_c=args.block_c, seed=args.seed,
                          device=args.device)
               for m in models]
    if args.dead_imports:
        sink = DiagnosticSink()
        src = Path(__file__).resolve().parents[2]  # .../src
        check_dead_imports(src, sink)
        reports.append({"model": "<repo>", "plan": None,
                        "diagnostics": sink.items})

    n_err = sum(len(errors(r["diagnostics"])) for r in reports)
    if args.as_json:
        doc = {"n_errors": n_err,
               "reports": [{**r, "diagnostics": [
                   d.to_json() for d in sort_diagnostics(r["diagnostics"])]}
                   for r in reports]}
        print(json.dumps(doc, indent=2))
    else:
        for r in reports:
            n_e = len(errors(r["diagnostics"]))
            verdict = "FAIL" if n_e else "ok"
            print(f"== {r['model']}: {verdict} "
                  f"({n_e} errors, {len(r['diagnostics']) - n_e} notes)")
            if r["plan"]:
                print(f"   plan: {' '.join(r['plan']['layers'])}")
            out = format_diagnostics(r["diagnostics"])
            if out:
                print("\n".join(f"   {line}" for line in out.splitlines()))
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
