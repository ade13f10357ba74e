"""Per-layer tile-geometry search: measure -> search -> plan, closed
(counterpart of `repro.obs.tilesearch`).

For each conv layer of a plan, at the (kind, impl) the planner chose, it
enumerates candidate `TileConfig` geometries over the dimensions the CUDA
kernel of that impl honours, prices each on the roofline model
(re-measuring the layer's channel-block occupancy at the candidate's
block_c and the weight block density at its bf, since geometry changes
what the schedule can skip), prunes the losing geometries without timing
them, times the survivors through `time_callable`, and picks a winner:

    S      = { timed candidates with measured_us <= default's measured_us }
    winner = argmin over S of (model_us, measured_us)

The default geometry is always timed and always in S, so the winner's
modeled and measured times are at most the default's: a searched plan can
tie or beat the defaults, never lose to them.

Winners go into the `CalibrationDB` tiles table (`put_tile`, keyed by
(device, kind, impl, layer shape)); `plan_network(tiles=db)` stamps them on
`LayerPlan.tile`, `run_unit` threads them into the kernels and
`PlanKey.tile_sig` keeps one runner per geometry. With fit=True the timings
also become per-tile calibration entries.

The grid is the card's own, not the reference's (`_CONV_BO = (8, 32, 128)`,
`_BSR_BT = (8, 16, 32)`, `_BSR_BD = (32, 64, 128)` there):
- fp32 ECR / PECR: block_c in `_CONV_BC` x block_o in (0, 64, 128): the
  output tiles `ecr_conv.cu` takes (`kernels.tiles.CUDA_BLOCK_O`), and 0,
  the kernel's own choice, so a layer narrower than 64 output channels
  still searches block_c;
- int8 ECR: block_c only (the int8 kernel's output tile is fixed);
- BSR and int8 BSR: bt = 8 (the kernels' only row block) x bf in `_BSR_BF`;
  no bd (the kernels tile the columns themselves).
Each dimension is intersected with the layer's extents, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.kernels.tiles import CUDA_BLOCK_O, CUDA_BSR_BT, DEFAULT_TILE, TileConfig

# power-of-two grids per honoured dimension (intersected with each layer's
# extents: a too-big size would fall back to the default and only re-time it)
_CONV_BC = (8, 16, 32, 64, 128)
_CONV_BO = (0,) + CUDA_BLOCK_O
_BSR_BF = (16, 32, 64, 128)


@dataclass(frozen=True)
class TileCandidate:
    """One priced geometry; measured_us < 0 means pruned before timing."""

    key: tuple  # TileConfig.key()
    model_us: float
    measured_us: float = -1.0
    spread: float = 0.0

    @property
    def timed(self) -> bool:
        return self.measured_us >= 0.0

    def row(self) -> dict:
        return {"tile": list(self.key), "model_us": round(self.model_us, 4),
                "measured_us": round(self.measured_us, 2),
                "spread": round(self.spread, 3), "timed": self.timed}


@dataclass(frozen=True)
class LayerTileSearch:
    """One layer's search result. `best` is the winning candidate; for an
    impl with no kernel geometry it is the default, alone."""

    index: int
    kind: str
    impl: str
    shape_key: tuple
    best: TileCandidate
    default: TileCandidate
    candidates: tuple  # every priced TileCandidate, default included

    @property
    def improved(self) -> bool:
        return self.best.key != DEFAULT_TILE.key() and (
            self.best.model_us < self.default.model_us
            or self.best.measured_us < self.default.measured_us)

    def row(self) -> dict:
        return {"layer": self.index, "kind": self.kind, "impl": self.impl,
                "shape": list(self.shape_key),
                "best": self.best.row(), "default": self.default.row(),
                "improved": self.improved,
                "n_candidates": len(self.candidates),
                "n_timed": sum(c.timed for c in self.candidates)}


@dataclass(frozen=True)
class TileSearchReport:
    graph_name: str
    device_kind: str
    batch: int
    layers: tuple  # tuple[LayerTileSearch, ...]

    def improved_layers(self) -> tuple:
        return tuple(r for r in self.layers if r.improved)

    def floor_holds(self) -> bool:
        """The guarantee, checked on the recorded numbers: every layer's
        winner models and measures no slower than its default."""
        return all(r.best.model_us <= r.default.model_us
                   and (not r.best.timed
                        or r.best.measured_us <= r.default.measured_us)
                   for r in self.layers)

    def summary(self) -> dict:
        return {"graph": self.graph_name, "device_kind": self.device_kind,
                "batch": self.batch, "layers": len(self.layers),
                "improved": len(self.improved_layers()),
                "floor_holds": self.floor_holds(),
                "model_speedup": round(
                    sum(r.default.model_us for r in self.layers)
                    / max(sum(r.best.model_us for r in self.layers), 1e-9), 4),
                "rows": [r.row() for r in self.layers]}


def _conv_candidates(c: int, o: int, block_o: bool) -> list:
    out = [DEFAULT_TILE]
    for bc in _CONV_BC:
        if bc > max(8, c):
            continue
        for bo in _CONV_BO if block_o else (0,):
            if bo > max(8, o):
                continue
            out.append(TileConfig(block_c=bc, block_o=bo))
    return out


def _bsr_candidates(k_taps: int) -> list:
    out = [DEFAULT_TILE]
    for bf in _BSR_BF:
        if bf > max(8, k_taps):
            continue
        out.append(TileConfig(bt=CUDA_BSR_BT, bf=bf))
    return out


def layer_tile_candidates(unit, kind: str, impl: str, batch: int) -> list:
    """The geometry grid one (layer, impl) searches over: the dimensions the
    impl's kernel honours, intersected with the layer's extents, default
    first. `batch` keeps the reference's signature (its column block grew
    with the patches; the card's kernels tile columns themselves)."""
    from repro_torch.graph.registry import get_op

    del batch
    op = get_op(kind, impl)
    c = unit.in_shape[0]
    if op.weight_sparse:
        return _bsr_candidates(c * unit.conv.k * unit.conv.k)
    return _conv_candidates(c, unit.conv.c_out, block_o=not op.quantized)


def search_layer(unit, w, x, kind: str, impl: str, *, iters: int = 2,
                 warmup: int = 1, prune_factor: float = 1.25,
                 max_timed: int = 4, calibration=None,
                 tracer=None) -> LayerTileSearch:
    """Search one layer's tile geometry at its planned (kind, impl).

    x is the layer's real input (the dense-oracle walk of `tile_search`), so
    the occupancy, re-measured per candidate block_c at the impl's operand
    width, prices the schedule each geometry would run. Candidates whose
    modeled time exceeds `prune_factor` x the modeled minimum are not timed;
    of the rest the `max_timed` modeled-best are (the default always is).
    Winner rule: see the module docstring.
    """
    from repro_torch.graph.executor import run_unit
    from repro_torch.graph.registry import get_op, unit_model_us
    from repro_torch.kernels.tiles import resolve_bsr_tile
    from repro_torch.obs.calibrate import unit_shape_key
    from repro_torch.obs.profile import time_callable
    from repro_torch.obs.trace import NULL_TRACER
    from repro_torch.pipeline.planner import measure_occupancy
    from repro_torch.sparse_weights.format import conv_weight_matrix, matrix_block_density

    tracer = tracer or NULL_TRACER
    op = get_op(kind, impl)
    shape_key = unit_shape_key(unit)
    batch = int(x.shape[0]) if x.ndim == 4 else 1
    if not op.pallas:
        # nothing to search: an impl without a kernel has no tile geometry
        m = unit_model_us(kind, impl, unit, batch=batch,
                          calibration=calibration)
        cand = TileCandidate(key=DEFAULT_TILE.key(), model_us=m)
        return LayerTileSearch(index=unit.index, kind=kind, impl=impl,
                               shape_key=shape_key, best=cand, default=cand,
                               candidates=(cand,))

    dtype_bytes = 1 if op.quantized else 4
    c = unit.in_shape[0]
    conv = unit.conv
    k_taps = c * conv.k * conv.k
    wm = conv_weight_matrix(w) if op.weight_sparse else None

    priced: list = []
    for t in layer_tile_candidates(unit, kind, impl, batch):
        occ = 1.0
        wd = 1.0
        if op.sparse:
            occ = measure_occupancy(x, tile=t, dtype_bytes=dtype_bytes)
        if op.weight_sparse:
            _, oh, ow = unit.conv_out_shape
            wd = matrix_block_density(
                wm, resolve_bsr_tile(conv.c_out, k_taps, batch * oh * ow, t))
        priced.append((t, unit_model_us(
            kind, impl, unit, occupancy=occ, weight_density=wd, batch=batch,
            tile=t if t else None, calibration=calibration)))

    best_model = min(m for _, m in priced)
    keep = [(t, m) for t, m in priced
            if not t or m <= prune_factor * best_model]
    # default first, then the modeled-best survivors up to the timing budget
    keep = [keep[0]] + sorted(keep[1:], key=lambda tm: tm[1])[:max_timed]

    cands: dict = {}
    for t, m in priced:
        cands[t.key()] = TileCandidate(key=t.key(), model_us=float(m))
    for t, m in keep:
        def fwd(x_, w_, t=t):
            return run_unit(x_, w_, unit, kind, impl, tile=t if t else None)

        with tracer.span("tile_search_layer", cat="kernel", layer=unit.index,
                         kind=kind, impl=impl, tile=str(t.key())):
            tm = time_callable(fwd, x, w, iters=iters, warmup=warmup,
                               outlier_tol=2.0)
        cands[t.key()] = TileCandidate(key=t.key(), model_us=float(m),
                                       measured_us=tm.median_us,
                                       spread=tm.spread)

    default = cands[DEFAULT_TILE.key()]
    eligible = [cd for cd in cands.values()
                if cd.timed and cd.measured_us <= default.measured_us]
    best = min(eligible, key=lambda cd: (cd.model_us, cd.measured_us))
    return LayerTileSearch(
        index=unit.index, kind=kind, impl=impl, shape_key=shape_key,
        best=best, default=default,
        candidates=tuple(sorted(cands.values(), key=lambda cd: cd.model_us)))


def tile_search(plan, params, calib, *, iters: int = 2, warmup: int = 1,
                prune_factor: float = 1.25, max_timed: int = 4,
                db=None, fit: bool = True, calibration=None,
                tracer=None):
    """Search every layer of `plan` at its planned impl; persist winners.

    Walks the plan's graph on `calib` with the dense oracle (each layer is
    searched on the input the plan was made for), runs `search_layer` per
    conv unit, and writes each winner into `db` (a `CalibrationDB`; one is
    created when None) through `put_tile`: a default winner erases a stale
    stored winner. fit=True also fits per-(impl, tile) calibration entries
    from the timed candidates (scale = median of modeled-default/measured,
    the `fit_report` rule), so a searched geometry is priced at its
    measured efficiency; only when `calibration` is None, since a ratio
    against an already calibrated model would apply the scales twice.

    Returns (TileSearchReport, db).
    """
    from repro_torch.graph.executor import run_unit
    from repro_torch.graph.ir import graph_weights
    from repro_torch.graph.registry import get_op
    from repro_torch.obs import constants
    from repro_torch.obs.calibrate import CalibEntry, CalibrationDB, _median, device_kind
    from repro_torch.obs.trace import NULL_TRACER

    tracer = tracer or NULL_TRACER
    graph = plan.graph
    if calib.ndim == 3:
        calib = calib[None]
    batch = int(calib.shape[0])
    db = db if db is not None else CalibrationDB(device=device_kind(calib.device))
    conv_ws, _ = graph_weights(params)
    rows: list = []
    x = calib
    with tracer.span("tile_search", graph=graph.name, batch=batch):
        for lp, (unit, w) in zip(plan.layers, zip(graph.units(), conv_ws)):
            r = search_layer(unit, w, x, lp.kind, lp.impl, iters=iters,
                             warmup=warmup, prune_factor=prune_factor,
                             max_timed=max_timed, calibration=calibration,
                             tracer=tracer)
            rows.append(r)
            if get_op(lp.kind, lp.impl).pallas:
                db.put_tile(lp.kind, lp.impl, r.shape_key,
                            TileConfig.from_key(r.best.key))
            x = run_unit(x, w, unit, "conv", "dense")  # dense-oracle walk
    if fit and calibration is None:
        base = constants.DEFAULT_ROOFLINE
        ratios: dict = {}
        for r in rows:
            for cd in r.candidates:
                if cd.timed:
                    ratios.setdefault((r.kind, r.impl, cd.key), []).append(
                        cd.model_us / max(cd.measured_us, 1e-9))
        for (kind, impl, tkey), rs in ratios.items():
            rs = sorted(rs)
            s = _median(rs)
            if s <= 0.0:
                continue
            db.put(kind, impl, 0, CalibEntry(
                peak_flops=base.peak_flops * s, hbm_bw=base.hbm_bw * s,
                scale=float(s), n_samples=len(rs),
                resid_spread=float((rs[-1] - rs[0]) / max(s, 1e-12))),
                tile=TileConfig.from_key(tkey))
    report = TileSearchReport(graph_name=graph.name,
                              device_kind=device_kind(calib.device),
                              batch=batch, layers=tuple(rows))
    return report, db
