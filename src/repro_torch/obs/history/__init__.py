"""Perf history: the cross-run benchmark trajectory store and regression
gate (counterpart of `repro.obs.history`).

- `db`        `BenchDB`: an append-only JSONL store of typed per-(bench,
              row, metric, device_kind) series; each point carries the
              producing git SHA, UTC timestamp, versions and device kind,
              so H100, TPU and host points never merge into one baseline.
              The file is the JAX package's `benchdb-v1`: a DB written by
              either package loads in the other;
- `baseline`  noise-aware verdicts: rolling median + MAD over the series
              window with minimum-sample guards, classifying each fresh
              point as regressed / improved / flat per metric;
- `records`   exporters folding `Engine.stats()["telemetry"]`,
              `ProfileReport` digests and `CalibrationDB` fits into the
              same record schema;
- `report`    trend tables (terminal / markdown) and a self-contained HTML
              dashboard with inline SVG sparklines;
- `cli`       `python -m repro_torch.obs.history.cli`: `ingest`,
              `diff <shaA> <shaB>`, `check` (exit 1 on a regression, 2 on
              an empty DB or bad input), `report`.

Entry point: `launch/serve_cnn.py --history DB` ingests the serving summary
and telemetry snapshot (and any fitted calibration).
"""
from repro_torch.obs.history.baseline import (
    Thresholds,
    Verdict,
    check_db,
    classify,
    diff_db,
    metric_direction,
    metric_noise_class,
)
from repro_torch.obs.history.db import BenchDB, BenchRecord, payload_records, run_context
from repro_torch.obs.history.records import (
    calibration_rows,
    make_payload,
    profile_rows,
    telemetry_rows,
)
from repro_torch.obs.history.report import html_report, trend_table

__all__ = [
    "BenchDB",
    "BenchRecord",
    "Thresholds",
    "Verdict",
    "calibration_rows",
    "check_db",
    "classify",
    "diff_db",
    "html_report",
    "make_payload",
    "metric_direction",
    "metric_noise_class",
    "payload_records",
    "profile_rows",
    "run_context",
    "telemetry_rows",
    "trend_table",
]
