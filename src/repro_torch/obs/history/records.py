"""Exporters: the port's other measurement products as BenchDB rows
(counterpart of `repro.obs.history.records`).

`payload_records` covers BENCH payloads; this module covers the three
in-process sources: the engine's telemetry snapshot, the profiler's per-impl
digest and the calibration DB's fitted scales, each as row dicts of the
`write_bench_json` shape, so one `make_payload` + `BenchDB.ingest_payload`
lands them in the same trajectory (same stamps, same gate).
"""
from __future__ import annotations

from repro_torch.obs.history.db import run_context


def make_payload(name: str, rows, extra: dict | None = None, device=None) -> dict:
    """A BENCH-shaped payload stamped with the current run context (git SHA,
    UTC timestamp, torch / CUDA versions, device kind and platform of
    `device`, None = the card when one is present)."""
    ctx = run_context(device)
    payload = {"name": name, "schema": "name,us_per_call,derived",
               "git_sha": ctx["git_sha"], "timestamp": ctx["timestamp"],
               "versions": ctx["versions"],
               "device_kind": ctx["device_kind"],
               "platform": ctx["platform"],
               "rows": list(rows)}
    if extra:
        payload.update(extra)
    return payload


def telemetry_rows(snapshot: dict, prefix: str = "engine") -> list:
    """`Engine.stats()["telemetry"]` (a `MetricsTracker.snapshot()`) as one
    history row: p50 / p95 / p99, fill and the re-plan counters. The
    unbounded sub-structures (occupancy timeline, event log) stay out: a
    trajectory point is a scalar."""
    lat = snapshot.get("latency", {}) or {}
    replans = snapshot.get("replans", {}) or {}
    row = {"name": prefix,
           "submitted": snapshot.get("submitted", 0),
           "completed": snapshot.get("completed", 0),
           "batches": snapshot.get("batches", 0),
           "pad_samples": snapshot.get("pad_samples", 0),
           "mean_fill": snapshot.get("mean_fill", 0.0),
           "service_s_total": snapshot.get("service_s_total", 0.0),
           "p50_ms": lat.get("p50_ms", 0.0),
           "p95_ms": lat.get("p95_ms", 0.0),
           "p99_ms": lat.get("p99_ms", 0.0),
           "mean_ms": lat.get("mean_ms", 0.0),
           "max_ms": lat.get("max_ms", 0.0),
           "replan_triggers": replans.get("triggers", 0),
           "replan_swaps": replans.get("swaps", 0),
           "replan_errors": replans.get("errors", 0),
           "hot_swaps": replans.get("hot_swaps", 0),
           "verify_rejects": replans.get("verify_rejects", 0)}
    return [row]


def profile_rows(report) -> list:
    """A `ProfileReport` as history rows: one per (kind, impl) group
    (measured total + median predicted/measured ratio) plus one agreement
    row (top-1 / pairwise ranking agreement of the cost model)."""
    summary = report.summary()
    rows = []
    for key, grp in sorted(summary["per_impl"].items()):
        rows.append({"name": f"profile/{summary['graph']}/{key}",
                     "layers": grp["layers"],
                     "measured_us_total": grp["measured_us_total"],
                     "ratio_median": grp["ratio_median"]})
    agr = summary["agreement"]
    rows.append({"name": f"profile/{summary['graph']}/agreement",
                 "top1_agreement": agr["top1"],
                 "pairwise_agreement": agr["pairwise"],
                 "layers": agr["layers"]})
    return rows


def calibration_rows(db) -> list:
    """A `CalibrationDB` as history rows: per fitted (device, kind, impl,
    geometry) key the efficiency scale and its residual spread."""
    from repro_torch.obs.calibrate import _fmt_tkey

    rows = []
    for (dev, kind, impl, tk), e in sorted(db.entries.items()):
        rows.append({"name": f"calib/{dev}/{kind}/{impl}/{_fmt_tkey(tk)}",
                     "scale": e.scale,
                     "resid_spread": e.resid_spread,
                     "n_samples": e.n_samples})
    return rows
