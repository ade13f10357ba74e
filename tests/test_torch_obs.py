"""Parity of the port's observability layer (`repro_torch.obs`: trace,
profile, calibrate) and its plumbing (registry, planner, engine) with the
JAX package's `repro.obs`, on the same inputs.

- Tracer: the same span / instant / counter script on a SimClock gives the
  same Chrome trace JSON, byte for byte.
- time_callable: with `time.perf_counter` patched to the same sequence, the
  same median, spread, samples and rejections.
- CalibrationDB: fitted from the same report rows, entries equal at 1e-12
  relative; a DB saved by either package (v2, and v1) loads in the other;
  lookup falls back in the same order.
- Registry and planner: `unit_model_us(calibration=db)` equal for every
  (kind, impl, unit) of the three tiny graphs, calibrated and tile-stamped
  plans identical, an empty DB plans bit-identically to none, a
  calibration shift flips the same layers. The port's roofline constants
  are patched to the reference's, as in `test_torch_planner.py`.
- profile_plan: rows equal on every field but the measured time and spread.
- Engine: spans recorded (null tracer by default), `profile()` fills the
  telemetry, a plan that differs only in tile builds its own runner.
"""
import json
import time

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.vgg19_sparse import CNNConfig as JCNNConfig  # noqa: E402
from repro.configs.vgg19_sparse import vgg19_graph as j_vgg19_graph  # noqa: E402
from repro.graph import registry as j_registry  # noqa: E402
from repro.kernels.tiles import TileConfig as JTile  # noqa: E402
from repro.obs import constants as j_constants  # noqa: E402
from repro.obs import calibrate as j_calibrate  # noqa: E402
from repro.obs import profile as j_profile  # noqa: E402
from repro.obs import trace as j_trace  # noqa: E402
from repro.pipeline.planner import plan_network as j_plan_network  # noqa: E402
from repro.serving.batcher import SimClock as JSimClock  # noqa: E402
from repro_torch.configs.vgg19_sparse import CNNConfig, vgg19_graph  # noqa: E402
from repro_torch.graph import registry  # noqa: E402
from repro_torch.kernels.tiles import TileConfig  # noqa: E402
from repro_torch.obs import constants  # noqa: E402
from repro_torch.obs import calibrate, profile, trace  # noqa: E402
from repro_torch.pipeline import plan_network  # noqa: E402
from repro_torch.serving import Engine, SimClock, plan_key, replay_stream  # noqa: E402
from test_torch_planner import GRAPHS  # noqa: E402
from test_torch_sparse_weights import _setup  # noqa: E402

PORT_IMPLS = sorted(registry._OPS)  # (kind, impl) pairs the port registers


@pytest.fixture
def reference_roofline(monkeypatch):
    monkeypatch.setattr(constants, "DEFAULT_ROOFLINE", constants.RooflineConstants(
        j_constants.DEFAULT_PEAK_FLOPS, j_constants.DEFAULT_HBM_BW))


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


def _trace_script(mod, clock):
    tr = mod.Tracer(clock=clock)
    with tr.span("plan", graph="g", occ_threshold=0.75):
        clock.advance(0.001)
        with tr.span("compile", bucket=4) as sp:
            clock.advance(0.0025)
            sp.annotate(fill=0.5)
        tr.instant("replan_trigger", delta=0.2)
        tr.counter("occupancy", 0.625)
    with pytest.raises(RuntimeError):
        with tr.span("execute_batch", bucket=2, n_real=1):
            clock.advance(0.003)
            raise RuntimeError("boom")
    with tr.span("profile_layer", cat="kernel", layer=3, kind="conv", impl="dense"):
        clock.advance(0.0007)
    return tr


def test_tracer_json_matches_reference(tmp_path):
    got = _trace_script(trace, SimClock(5.0))
    want = _trace_script(j_trace, JSimClock(5.0))
    assert got.chrome_trace() == want.chrome_trace()
    got.save(str(tmp_path / "a.json"))
    want.save(str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()
    names = [e["name"] for e in got.events]
    assert names == ["compile", "replan_trigger", "occupancy", "plan",
                     "execute_batch", "profile_layer"]
    assert got.events[4]["args"]["error"] == "RuntimeError"


def test_null_tracer_records_nothing():
    a, b = trace.NULL_TRACER.span("x"), trace.NULL_TRACER.span("y", k=1)
    assert a is b  # one shared no-op object
    with a:
        pass
    assert trace.NULL_TRACER.events == ()
    assert trace.NULL_TRACER.chrome_trace() == j_trace.NULL_TRACER.chrome_trace()
    with pytest.raises(ValueError):
        trace.NULL_TRACER.save("unused.json")


def test_tracer_tids_are_logical():
    import threading

    tr = trace.Tracer(clock=SimClock())
    with tr.span("main"):
        pass
    t = threading.Thread(target=lambda: tr.span("worker").__enter__().__exit__(None, None, None))
    t.start()
    t.join(10)
    assert not t.is_alive()
    assert [e["tid"] for e in tr.events] == [0, 1]


# ---------------------------------------------------------------------------
# time_callable
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps_us,outlier_tol", [
    ((10.0, 12.0, 11.0), 0.0),
    ((10.0, 12.0, 11.0, 95.0, 10.5), 0.5),
    ((10.0, 95.0, 11.0, 10.5), 2.0),
    ((7.0,), 0.5),
    ((10.0, 40.0, 42.0, 41.0), 0.1),
])
def test_time_callable_matches_reference(monkeypatch, steps_us, outlier_tol):
    """Each timed call reads the clock twice; the patched clock advances by
    the given microseconds inside each call."""

    def run(mod, f):
        ticks = []
        for d in steps_us:
            ticks += [1.0, 1.0 + d * 1e-6]
        it = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(it))
        try:
            return mod.time_callable(f, iters=len(steps_us), warmup=2,
                                     outlier_tol=outlier_tol)
        finally:
            monkeypatch.undo()

    got = run(profile, lambda: torch.zeros(2))
    want = run(j_profile, lambda: jnp.zeros(2))
    assert got.median_us == pytest.approx(want.median_us, rel=1e-12)
    assert got.spread == pytest.approx(want.spread, rel=1e-12, abs=1e-12)
    assert got.rejected == want.rejected
    assert got.samples_us == pytest.approx(want.samples_us, rel=1e-12)


def test_time_callable_waits_for_every_call():
    calls = []
    r = profile.time_callable(lambda: calls.append(1) or torch.ones(1), iters=3, warmup=2)
    assert len(calls) == 5 and len(r.samples_us) == 3 and r.rejected == 0


# ---------------------------------------------------------------------------
# CalibrationDB
# ---------------------------------------------------------------------------


def _rows(mod):
    """The same LayerTiming rows in either package: three impls, two block
    geometries, one tiled row."""
    spec = [  # index, kind, impl, measured, predicted, tile
        (0, "conv", "dense", 100.0, 20.0, ()),
        (1, "conv", "dense", 80.0, 30.0, ()),
        (2, "conv", "dense", 55.0, 12.5, ()),
        (0, "conv", "ecr_pallas", 400.0, 10.0, ()),
        (1, "conv", "ecr_pallas", 300.0, 9.0, ()),
        (1, "conv_pool", "pecr_pallas", 250.0, 7.0, ()),
        (2, "conv", "ecr_pallas", 90.0, 6.0, (16, 128, 0, 0, 0)),
        (2, "conv", "bsr", 70.0, 4.0, ()),
    ]
    return tuple(mod.LayerTiming(
        index=i, kind=k, impl=m, occupancy=0.5, weight_density=1.0, batch=2,
        block_c=8, measured_us=meas, spread=0.1, predicted_us=pred, flops=1e6,
        bytes=1e5, tile=tile) for i, k, m, meas, pred, tile in spec)


def _report(mod):
    return mod.ProfileReport(graph_name="g", device_kind="cpu", batch=2, block_c=8,
                             timings=_rows(mod))


def _entries(db):
    return {k: (e.peak_flops, e.hbm_bw, e.scale, e.n_samples, e.resid_spread)
            for k, e in db.entries.items()}


def _assert_entries_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k][3] == b[k][3]
        for x, y in zip(a[k][:3] + a[k][4:], b[k][:3] + b[k][4:]):
            assert x == pytest.approx(y, rel=1e-12, abs=0.0)


def test_calibration_fit_matches_reference(reference_roofline):
    got = calibrate.CalibrationDB.from_report(_report(profile))
    want = j_calibrate.CalibrationDB.from_report(_report(j_profile))
    _assert_entries_equal(_entries(got), _entries(want))
    assert got.device == want.device == "cpu"
    assert got.summary() == want.summary()
    assert _report(profile).agreement() == _report(j_profile).agreement()
    assert _report(profile).summary()["per_impl"] == _report(j_profile).summary()["per_impl"]


def test_calibration_db_loads_across_packages(tmp_path, reference_roofline):
    port = calibrate.CalibrationDB.from_report(_report(profile))
    port.put_tile("conv", "ecr_pallas", (16, 12, 12, 16, 3, 1, 0), TileConfig(16, 128),
                  device="cpu")
    ref = j_calibrate.CalibrationDB.from_report(_report(j_profile))
    ref.put_tile("conv", "ecr_pallas", (16, 12, 12, 16, 3, 1, 0), JTile(16, 128),
                 device="cpu")
    port.save(str(tmp_path / "port.json"))
    ref.save(str(tmp_path / "ref.json"))
    assert (tmp_path / "port.json").read_text() == (tmp_path / "ref.json").read_text()
    into_ref = j_calibrate.CalibrationDB.load(str(tmp_path / "port.json"))
    into_port = calibrate.CalibrationDB.load(str(tmp_path / "ref.json"))
    _assert_entries_equal(_entries(into_ref), _entries(ref))
    _assert_entries_equal(_entries(into_port), _entries(port))
    assert into_port.tiles == port.tiles and into_ref.tiles == ref.tiles
    assert into_port.best_tile("conv", "ecr_pallas", (16, 12, 12, 16, 3, 1, 0)) == \
        TileConfig(16, 128)


def test_calibration_v1_schema_loads_in_both(tmp_path):
    v1 = {"schema": "calibration-v1", "device": "cpu", "entries": [
        {"device": "cpu", "kind": "conv", "impl": "ecr_pallas", "block_c": 8,
         "peak_flops": 1e12, "hbm_bw": 1e10, "scale": 0.5, "n_samples": 3,
         "resid_spread": 0.25}]}
    path = tmp_path / "v1.json"
    path.write_text(json.dumps(v1))
    got = calibrate.CalibrationDB.load(str(path))
    want = j_calibrate.CalibrationDB.load(str(path))
    assert _entries(got) == _entries(want)
    assert ("cpu", "conv", "ecr_pallas", (8, 0, 0, 0, 0)) in got.entries
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "other"}))
    with pytest.raises(ValueError, match="not a calibration DB"):
        calibrate.CalibrationDB.load(str(bad))


def test_lookup_falls_back_in_the_reference_order(reference_roofline):
    def fill(mod, tile_cls):
        db = mod.CalibrationDB(device="cpu")
        for i, (bc, tile) in enumerate([(0, None), (8, None),
                                        (0, tile_cls(16, 128)), (0, tile_cls(bt=8, bf=32))]):
            db.put("conv", "ecr_pallas", bc, mod.CalibEntry(1e12 * (i + 1), 1e10 * (i + 1),
                                                            0.1 * (i + 1), 1, 0.0), tile=tile)
        return db

    got, want = fill(calibrate, TileConfig), fill(j_calibrate, JTile)
    queries = [(0, None), (8, None), (16, None), (8, (8, 64)), (16, (16, 128)),
               (32, (32, 128)), (0, (0, 0, 8, 32, 0)), (0, (0, 0, 8, 64, 0))]
    for bc, key in queries:
        tg = TileConfig.from_key(key + (0,) * (5 - len(key))) if key else None
        tw = JTile.from_key(key + (0,) * (5 - len(key))) if key else None
        a = got.lookup("conv", "ecr_pallas", bc, tile=tg)
        b = want.lookup("conv", "ecr_pallas", bc, tile=tw)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.peak_flops, a.hbm_bw) == (b.peak_flops, b.hbm_bw)
        c = got.constants_for("conv", "dense", bc, tile=tg)
        d = want.constants_for("conv", "dense", bc, tile=tw)
        assert (c.peak_flops, c.hbm_bw) == (d.peak_flops, d.hbm_bw)
    assert not calibrate.CalibrationDB(device="cpu")
    assert calibrate.CalibrationDB(device="cpu").constants_for("conv", "dense") \
        is constants.DEFAULT_ROOFLINE


def test_device_kind_of_the_host():
    assert calibrate.device_kind(torch.device("cpu")) == "cpu" == j_calibrate.device_kind()


# ---------------------------------------------------------------------------
# registry and planner
# ---------------------------------------------------------------------------


def _db_pair(scales: dict, block_c: int = 8):
    """The same DB in both packages: (kind, impl) -> (scale, tile key)."""
    dbs = []
    for mod, tile_cls, base in ((calibrate, TileConfig, None), (j_calibrate, JTile, None)):
        db = mod.CalibrationDB(device="cpu")
        for (kind, impl), (s, key) in scales.items():
            peak = j_constants.DEFAULT_PEAK_FLOPS * s
            bw = j_constants.DEFAULT_HBM_BW * s
            db.put(kind, impl, block_c, mod.CalibEntry(peak, bw, s, 2, 0.0),
                   tile=tile_cls.from_key(key) if key else None)
        dbs.append(db)
    return dbs


SCALES = {("conv", "dense"): (0.5, None), ("conv", "ecr_pallas"): (0.02, None),
          ("conv_pool", "pecr_pallas"): (0.03, None), ("conv", "bsr"): (0.2, None),
          ("conv", "ecr_int8"): (0.05, (16, 0, 0, 0, 0)),
          ("conv", "bsr_int8"): (0.1, (0, 0, 8, 32, 0))}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_unit_model_us_with_calibration_matches_reference(name, reference_roofline):
    jg, tg, *_ = _setup(name)
    db, jdb = _db_pair(SCALES)
    tiles = [None, (8, 0, 0, 0, 0), (16, 0, 0, 0, 0), (0, 0, 8, 32, 0), (16, 128, 0, 0, 0)]
    n = 0
    for ju, tu in zip(jg.units(), tg.units()):
        for kind, impl in PORT_IMPLS:
            if kind == "conv_pool" and tu.pool is None:
                continue
            for key in tiles:
                for occ, wd, bc in ((1.0, 1.0, 8), (0.375, 0.3, 0), (0.5, 0.6, 8)):
                    kw = dict(occupancy=occ, weight_density=wd, batch=2, block_c=bc)
                    got = registry.unit_model_us(
                        kind, impl, tu, tile=TileConfig.from_key(key) if key else None,
                        calibration=db, **kw)
                    want = j_registry.unit_model_us(
                        kind, impl, ju, tile=JTile.from_key(key) if key else None,
                        calibration=jdb, **kw)
                    assert got == pytest.approx(want, rel=1e-12), (kind, impl, key, kw)
                    assert registry.unit_model_us(kind, impl, tu, **kw) == pytest.approx(
                        j_registry.unit_model_us(kind, impl, ju, **kw), rel=1e-12)
                    n += 1
    assert n > 0


def _plans(name, occ, **kw):
    jg, tg, jp, tp, calib = _setup(name)
    db_t, db_j = kw.pop("dbs", (None, None))
    tiles_t, tiles_j = kw.pop("tiles", (None, None))
    want = j_plan_network(jp, jnp.asarray(calib), jg, occ_threshold=occ, block_c=8,
                          calibration=db_j, tiles=tiles_j, **kw)
    got = plan_network(tp, torch.from_numpy(calib), tg, occ_threshold=occ, block_c=8,
                       calibration=db_t, tiles=tiles_t, **kw)
    return got, want


def _same_plans(got, want):
    assert [(lp.kind, lp.impl) for lp in got.layers] == \
        [(lp.kind, lp.impl) for lp in want.layers]
    assert [lp.tile.key() if lp.tile else None for lp in got.layers] == \
        [lp.tile.key() if lp.tile else None for lp in want.layers]
    for a, b in zip(got.layers, want.layers):
        assert a.occupancy == pytest.approx(b.occupancy, abs=1e-6)


@pytest.mark.parametrize("occ", [0.75, 1.0])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_calibrated_and_tiled_plans_match_reference(name, occ, reference_roofline):
    """Calibrated constants and stored tile winners (a winner for every
    kernel impl at every unit's shape) give identical (kind, impl, tile)."""
    _, tg, *_ = _setup(name)
    db, jdb = _db_pair({("conv", "dense"): (0.5, None), ("conv", "ecr_pallas"): (0.3, None),
                        ("conv_pool", "pecr_pallas"): (0.4, None)})
    for unit in tg.units():
        key = calibrate.unit_shape_key(unit)
        for kind, impl, tkey in (("conv", "ecr_pallas", (16, 128, 0, 0, 0)),
                                 ("conv_pool", "pecr_pallas", (16, 0, 0, 0, 0)),
                                 ("conv", "ecr_int8", (16, 0, 0, 0, 0))):
            db.put_tile(kind, impl, key, tkey, device="cpu")
            jdb.put_tile(kind, impl, key, tkey, device="cpu")
    got, want = _plans(name, occ, dbs=(db, jdb), tiles=(db, jdb))
    _same_plans(got, want)
    if got.counts()["sparse"]:
        assert any(lp.tile for lp in got.layers)
    got8, want8 = _plans(name, occ, dbs=(db, jdb), tiles=(db, jdb), int8=True,
                         int8_budget=0.0)
    _same_plans(got8, want8)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_empty_db_plans_bit_identically(name):
    _, tg, _, tp, calib = _setup(name)
    x = torch.from_numpy(calib)
    for occ in (0.75, 1.0):
        base = plan_network(tp, x, tg, occ_threshold=occ, block_c=8)
        empty = calibrate.CalibrationDB(device="cpu")
        got = plan_network(tp, x, tg, occ_threshold=occ, block_c=8, calibration=empty,
                           tiles=empty)
        assert got == base and plan_key(2, got) == plan_key(2, base)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_calibration_shift_flips_the_same_layers(name, reference_roofline):
    """Sparse kernels measured at 1e-6 of the roofline, dense at it: the
    occupancy rule's re-check moves the same layers to dense in both."""
    db, jdb = _db_pair({("conv", "ecr_pallas"): (1e-6, None),
                        ("conv_pool", "pecr_pallas"): (1e-6, None),
                        ("conv", "dense"): (1.0, None)})
    base, _ = _plans(name, 1.0)
    got, want = _plans(name, 1.0, dbs=(db, jdb))
    _same_plans(got, want)
    assert base.counts()["sparse"] >= 1
    assert got.counts()["sparse"] < base.counts()["sparse"]


# ---------------------------------------------------------------------------
# profile_plan and the engine
# ---------------------------------------------------------------------------

TINY = dict(name="vgg-obs-tiny", in_channels=16, img_size=12, plan=((8, 1), (16, 1)),
            n_classes=4)


@pytest.fixture(scope="module")
def tiny():
    """(jax graph, torch graph, jax params, torch params, calib numpy) of a
    two-conv VGG, weights made once with numpy and handed to both."""
    from repro_torch.convert import params_from_jax
    from repro_torch.graph import init_graph
    from repro_torch.launch.serve_cnn import synth_requests
    from repro_torch.models.cnn import shift_dead_channels

    jg, tg = j_vgg19_graph(JCNNConfig(**TINY)), vgg19_graph(CNNConfig(**TINY))
    tp = shift_dead_channels(init_graph(torch.Generator().manual_seed(0), tg, device="cpu"))
    npp = {k: [w.numpy() for w in ws] for k, ws in tp.items()}
    calib = torch.stack(synth_requests(tg, 2, seed=1, device="cpu")).numpy()
    jp = {k: [jnp.asarray(w) for w in ws] for k, ws in npp.items()}
    return jg, tg, jp, params_from_jax(npp, device="cpu"), calib


def test_profile_plan_rows_match_reference(tiny, reference_roofline):
    jg, tg, jp, tp, calib = tiny
    jplan = j_plan_network(jp, jnp.asarray(calib), jg, occ_threshold=0.75, block_c=8)
    plan = plan_network(tp, torch.from_numpy(calib), tg, occ_threshold=0.75, block_c=8)
    tr = trace.Tracer(clock=SimClock())
    got = profile.profile_plan(plan, tp, torch.from_numpy(calib), iters=1, warmup=0,
                               tracer=tr)
    want = j_profile.profile_plan(jplan, jp, jnp.asarray(calib), iters=1, warmup=0)
    assert (got.graph_name, got.device_kind, got.batch, got.block_c) == \
        (want.graph_name, want.device_kind, want.batch, want.block_c)
    assert len(got.timings) == len(want.timings) > 0
    for a, b in zip(got.timings, want.timings):
        assert (a.index, a.kind, a.impl, a.batch, a.block_c, a.tile) == \
            (b.index, b.kind, b.impl, b.batch, b.block_c, b.tile)
        for f in ("occupancy", "weight_density", "predicted_us", "flops", "bytes"):
            assert getattr(a, f) == pytest.approx(getattr(b, f), rel=1e-6, abs=1e-9), f
        assert a.measured_us > 0
    names = [e["name"] for e in tr.events]
    assert names.count("profile_layer") == len(got.timings) and names[-1] == "profile"
    db = calibrate.CalibrationDB.from_report(got)
    assert {(k, i) for (_, k, i, _) in db.entries} == set(got.by_impl())
    # calibrated constants are the defaults times each impl's scale
    scale = {(k, i): e.scale for (_, k, i, _), e in db.entries.items()}
    recal = got.recalibrated(db)
    assert [t.predicted_us for t in recal.timings] == pytest.approx(
        [t.predicted_us / scale[(t.kind, t.impl)] for t in got.timings], rel=1e-9)


def _engine(tiny, **kw):
    _, tg, _, tp, calib = tiny
    return Engine(tp, graph=tg, calib=torch.from_numpy(calib), occ_threshold=0.75,
                  block_c=8, max_batch=4, deadline_s=0.005, device="cpu", **kw)


def test_engine_traces_and_profiles(tiny):
    clock = SimClock()
    tr = trace.Tracer(clock=clock)
    eng = _engine(tiny, clock=clock, tracer=tr, sim_service_s=0.003)
    calib = torch.from_numpy(tiny[4])
    replay_stream(eng, [calib[i % 2] for i in range(6)], rate_rps=200.0)
    names = [e["name"] for e in tr.events]
    assert "plan" in names and "compile" in names
    execs = [e for e in tr.events if e["name"] == "execute_batch"]
    assert len(execs) == eng.n_batches >= 1
    assert all(e["dur"] == pytest.approx(3000.0) for e in execs)
    assert eng.stats()["telemetry"]["profile"] is None
    report = eng.profile(iters=1, warmup=0)  # the last real batch
    digest = eng.stats()["telemetry"]["profile"]
    assert digest["graph"] == tiny[1].name and digest["device_kind"] == "cpu"
    assert len(digest["rows"]) == len(report.timings)
    assert [e["name"] for e in tr.events].count("profile_layer") == len(report.timings)


def test_engine_default_tracer_is_null(tiny):
    eng = _engine(tiny)
    assert eng.tracer is trace.NULL_TRACER
    assert eng.serve([torch.from_numpy(tiny[4][0])]).shape == (1, 4)
    with pytest.raises(ValueError, match="imgs="):
        _engine(tiny).profile()


def test_a_plan_that_differs_only_in_tile_builds_its_own_runner(tiny):
    from dataclasses import replace

    eng = _engine(tiny)
    assert eng.warmup([2]) == 1
    sparse = [i for i, lp in enumerate(eng.plan.layers) if lp.impl != "dense"]
    assert sparse
    layers = list(eng.plan.layers)
    layers[sparse[0]] = replace(layers[sparse[0]], tile=TileConfig(block_c=16))
    tiled = replace(eng.plan, layers=tuple(layers))
    assert plan_key(2, tiled).tile_sig == ((layers[sparse[0]].index, (16, 0, 0, 0, 0)),)
    assert plan_key(2, tiled) != plan_key(2, eng.plan)
    eng.plan = tiled
    assert eng.warmup([2]) == 1 and eng.stats()["plan_tiled"] == 1
    x = torch.from_numpy(tiny[4])
    got = eng.serve([x[0], x[1]])
    eng.plan = replace(tiled, layers=tuple(replace(lp, tile=None) for lp in tiled.layers))
    np.testing.assert_allclose(got, eng.serve([x[0], x[1]]), rtol=1e-5, atol=1e-6)


def test_engine_replans_through_calibration_and_tiles(tiny):
    """A drift re-plan goes through the engine's calibration: with the
    sparse kernels priced far below dense, the re-plan lands on dense."""
    db = calibrate.CalibrationDB(device="cpu")
    for kind, impl in (("conv", "ecr_pallas"), ("conv_pool", "pecr_pallas")):
        db.put(kind, impl, 8, calibrate.CalibEntry(1e6, 1e3, 1e-7, 1, 0.0))
    eng = _engine(tiny, clock=SimClock(), replan_band=0.0, replan_cooldown=0,
                  sim_service_s=0.001)
    assert eng.plan.counts()["sparse"] >= 1
    eng.calibration = db
    x = torch.from_numpy(tiny[4]).clone()
    x[:, : x.shape[1] // 2] = 0.0  # fewer live channels: the occupancy drifts
    replay_stream(eng, [x[0], x[1]] * 4, rate_rps=100.0)
    assert eng.n_replans >= 1 and eng.plan.counts()["sparse"] == 0
