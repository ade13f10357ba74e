"""Observability: span tracing, per-layer profiling, cost-model calibration
and tile-geometry search (counterpart of `repro.obs`).

- `trace`      span tracer (plan -> compile -> per-batch execute ->
               per-layer kernel), deterministic on a SimClock, exported as
               Chrome trace_event JSON;
- `profile`    the timing harness (`time_callable`) and `profile_plan`,
               which times every layer of a plan per impl at its real shapes
               beside the registry's modeled time;
- `calibrate`  `CalibrationDB`: effective roofline constants fitted per
               (device kind x op kind x impl x tile geometry) from a
               `ProfileReport`, read by `unit_model_us`, `plan_model_us` and
               `plan_network` through `calibration=`; the datasheet
               `constants` stay the fallback;
- `constants`  the card's datasheet roofline pair;
- `tilesearch` the per-layer kernel-geometry search (`tile_search`), whose
               winners `plan_network(tiles=...)` stamps on the plan;
- `history`    the cross-run layer: `BenchDB`, an append-only JSONL
               trajectory of serving, telemetry, profile and calibration
               points keyed by device kind, rolling-baseline verdicts, and
               the `python -m repro_torch.obs.history.cli` gate.
"""
from repro_torch.obs.calibrate import CalibEntry, CalibrationDB, device_kind, unit_shape_key
from repro_torch.obs.history import (
    BenchDB,
    Thresholds,
    calibration_rows,
    check_db,
    make_payload,
    profile_rows,
    telemetry_rows,
)
from repro_torch.obs.constants import (
    DEFAULT_HBM_BW,
    DEFAULT_PEAK_FLOPS,
    DEFAULT_ROOFLINE,
    RooflineConstants,
)
from repro_torch.obs.profile import (
    PROFILE_IMPLS,
    LayerTiming,
    ProfileReport,
    TimingResult,
    profile_plan,
    time_callable,
)
from repro_torch.obs.tilesearch import (
    LayerTileSearch,
    TileCandidate,
    TileSearchReport,
    layer_tile_candidates,
    search_layer,
    tile_search,
)
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Tracer

__all__ = [
    "BenchDB",
    "CalibEntry",
    "CalibrationDB",
    "DEFAULT_HBM_BW",
    "DEFAULT_PEAK_FLOPS",
    "DEFAULT_ROOFLINE",
    "LayerTileSearch",
    "LayerTiming",
    "NULL_TRACER",
    "NullTracer",
    "PROFILE_IMPLS",
    "ProfileReport",
    "RooflineConstants",
    "TileCandidate",
    "TileSearchReport",
    "Thresholds",
    "TimingResult",
    "Tracer",
    "calibration_rows",
    "check_db",
    "device_kind",
    "layer_tile_candidates",
    "make_payload",
    "profile_plan",
    "profile_rows",
    "search_layer",
    "telemetry_rows",
    "tile_search",
    "time_callable",
    "unit_shape_key",
]
