"""Parity of the port's tile geometry and tile search (`repro_torch.kernels.
tiles`, `repro_torch.obs.tilesearch`) and of its autotuner
(`repro_torch.serving.autotune`) with the JAX package's.

The port's grid is the card's own (fp32 ECR / PECR: block_c x block_o in
{0, 64, 128}; int8 ECR: block_c; BSR: bt = 8 x bf; no bd), so the packages
are compared on the geometries both grids hold:
- `TileConfig` keys round-trip to the reference's 5-tuple;
- `resolve_bsr_tile` honours bf by the reference's rule for every bt = 8
  request; another bt falls back to 8, and bd changes nothing;
- candidates conform to the layer, default first;
- `search_layer` prices every shared candidate at the reference's model_us;
- with timings injected by geometry, the winner, the floor and the DB
  contents (winners and per-tile fits) equal the reference's;
- a default winner erases a stale entry; `tile_search` -> `plan_network(
  tiles=)` closes the loop; `run_unit` at every card-grid geometry matches
  the default (plain versions here) within the fp32 limit;
- autotune in model mode picks the reference's candidates, dedup and
  winner; in time mode the fastest by the port's own clock.
The port's roofline constants are patched to the reference's where model
times are compared.
"""
import ast

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graph.executor import run_unit as j_run_unit  # noqa: E402
from repro.kernels.tiles import TileConfig as JTile  # noqa: E402
from repro.kernels.tiles import as_tile as j_as_tile  # noqa: E402
from repro.kernels.tiles import resolve_bsr_tile as j_resolve_bsr_tile  # noqa: E402
from repro.obs import calibrate as j_calibrate  # noqa: E402
from repro.obs import constants as j_constants  # noqa: E402
from repro.obs import profile as j_profile  # noqa: E402
from repro.obs import tilesearch as j_tilesearch  # noqa: E402
from repro.serving.autotune import autotune as j_autotune  # noqa: E402
from repro_torch.graph.executor import run_unit  # noqa: E402
from repro_torch.graph.registry import get_op  # noqa: E402
from repro_torch.kernels.tiles import (  # noqa: E402
    CUDA_BLOCK_O,
    DEFAULT_TILE,
    TileConfig,
    as_tile,
    resolve_block_o,
    resolve_bsr_tile,
)
from repro_torch.obs import calibrate, constants, profile, tilesearch  # noqa: E402
from repro_torch.pipeline import plan_network, run_plan  # noqa: E402
from repro_torch.serving import autotune, plan_key  # noqa: E402
from repro_torch.sparse_weights.prune import prune_graph_params  # noqa: E402
from test_torch_planner import GRAPHS  # noqa: E402
from test_torch_sparse_weights import _setup  # noqa: E402

KEYS = [(0, 0, 0, 0, 0), (8, 0, 0, 0, 0), (16, 128, 0, 0, 0), (0, 0, 8, 32, 0),
        (0, 0, 8, 64, 128), (12, 64, 16, 16, 32), (128, 8, 32, 128, 64)]


@pytest.fixture
def reference_roofline(monkeypatch):
    monkeypatch.setattr(constants, "DEFAULT_ROOFLINE", constants.RooflineConstants(
        j_constants.DEFAULT_PEAK_FLOPS, j_constants.DEFAULT_HBM_BW))


# ---------------------------------------------------------------------------
# TileConfig and the BSR resolution
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", KEYS)
def test_tile_keys_round_trip_against_the_reference(key):
    t, jt = TileConfig.from_key(key), JTile.from_key(key)
    assert t.key() == jt.key() == key
    assert bool(t) == bool(jt) == any(key)
    assert as_tile(t, 8).key() == j_as_tile(jt, 8).key()
    assert as_tile(None, 8).key() == j_as_tile(None, 8).key() == (8, 0, 0, 0, 0)
    assert not DEFAULT_TILE


@pytest.mark.parametrize("o,k_taps,p", [(64, 27, 401408), (64, 576, 100), (512, 4608, 1568),
                                        (6, 25, 64), (16, 144, 7), (70, 9, 130)])
def test_resolve_bsr_tile_matches_the_reference_at_bt_8(o, k_taps, p):
    """bt 0 or 8: bf by the reference's per-dimension rule (non-conforming
    requests fall back to weight_block's); bd changes nothing."""
    for bt in (0, 8):
        for bf in (0, -4, 8, 16, 24, 32, 64, 128, 4096, 10 ** 6):
            for bd in (0, 32, 128, 10 ** 6):
                got = resolve_bsr_tile(o, k_taps, p, TileConfig(bt=bt, bf=bf, bd=bd))
                want = j_resolve_bsr_tile(o, k_taps, p, JTile(bt=bt, bf=bf, bd=bd))
                assert got == want[:2], (bt, bf, bd)
                assert got == resolve_bsr_tile(o, k_taps, p, TileConfig(bt=bt, bf=bf))
    assert resolve_bsr_tile(o, k_taps, p) == j_resolve_bsr_tile(o, k_taps, p)[:2]


@pytest.mark.parametrize("bt", [16, 32, 4])
def test_another_bt_falls_back_to_the_kernels_8(bt):
    """The CUDA BSR kernels take 8-row blocks only: bf is still honoured."""
    for bf in (16, 64):
        got = resolve_bsr_tile(512, 4608, 1568, TileConfig(bt=bt, bf=bf))
        want = j_resolve_bsr_tile(512, 4608, 1568, JTile(bt=bt, bf=bf))
        assert got == (8, bf) and want[:2] == (bt, bf)


def test_resolve_block_o_takes_the_kernels_tiles():
    for o in (16, 64, 70, 128, 512):
        for bo in (0, 8, 32, 64, 96, 128, 256):
            want = bo if bo in CUDA_BLOCK_O and bo <= max(8, o) else 0
            assert resolve_block_o(o, bo) == want
    assert resolve_block_o(512) == 0


# ---------------------------------------------------------------------------
# candidate grids
# ---------------------------------------------------------------------------

KERNEL_IMPLS = (("conv", "ecr_pallas"), ("conv_pool", "pecr_pallas"), ("conv", "bsr"),
                ("conv", "ecr_int8"), ("conv", "bsr_int8"))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_card_grid_candidates_conform_default_first(name):
    _, tg, *_ = _setup(name)
    from repro_torch.graph.registry import fusion_eligible

    for unit in tg.units():
        c, o, k = unit.in_shape[0], unit.conv.c_out, unit.conv.k
        for kind, impl in KERNEL_IMPLS:
            if kind == "conv_pool" and not fusion_eligible(unit):
                continue
            cands = tilesearch.layer_tile_candidates(unit, kind, impl, batch=2)
            assert cands[0] == DEFAULT_TILE and all(cands[1:])
            assert len(set(cands)) == len(cands) >= 2
            for t in cands[1:]:
                if get_op(kind, impl).weight_sparse:
                    assert (t.block_c, t.block_o, t.bt, t.bd) == (0, 0, 8, 0)
                    assert 0 < t.bf <= max(8, c * k * k)
                else:
                    assert 0 < t.block_c <= max(8, c) and (t.bt, t.bf, t.bd) == (0, 0, 0)
                    allowed = (0,) if impl == "ecr_int8" else (0,) + CUDA_BLOCK_O
                    assert t.block_o in allowed and t.block_o <= max(8, o)
    with pytest.raises(ValueError):
        tilesearch.layer_tile_candidates(unit, "conv", "nope", batch=2)


# ---------------------------------------------------------------------------
# search parity
# ---------------------------------------------------------------------------

_PRUNED: dict = {}


def _pruned(name):
    """(jax graph, torch graph, jax params, torch params, calib) with the
    weights block-pruned to 0.3 by the port (the same values go to both)."""
    if name not in _PRUNED:
        jg, tg, _, tp, calib = _setup(name)
        pp, _ = prune_graph_params(tp, 0.3, tg, probe=torch.from_numpy(calib))
        jp = {k: [jnp.asarray(w.numpy()) for w in ws] for k, ws in pp.items()}
        _PRUNED[name] = (jg, tg, jp, pp, calib)
    return _PRUNED[name]


def _layer_inputs(tg, tp, calib):
    """Each unit's real input: the dense walk of the calibration batch."""
    xs, x = [], torch.from_numpy(calib)
    for unit, w in zip(tg.units(), tp["conv"]):
        xs.append(x)
        x = run_unit(x, w, unit, "conv", "dense")
    return xs


class _KeyTracer:
    """Records the layer and tile of the open "tile_search_layer" span, which
    both packages name with str(TileConfig.key()), so an injected clock can
    time by geometry."""

    def __init__(self):
        self.tile = self.layer = None

    def span(self, name, cat="repro", **args):
        import contextlib

        if "tile" in args:
            self.tile, self.layer = args["tile"], args["layer"]
        return contextlib.nullcontext()


def _inject(monkeypatch, timing):
    """Patch both packages' time_callable: the measured time of a candidate
    is timing(its key, its layer), read from the shared tracer; nothing
    runs."""
    tr = _KeyTracer()

    def fake(mod):
        def time_callable(f, *args, **kw):
            t = float(timing(ast.literal_eval(tr.tile), tr.layer))
            return mod.TimingResult(median_us=t, spread=0.0, samples_us=(t,))
        return time_callable

    monkeypatch.setattr(profile, "time_callable", fake(profile))
    monkeypatch.setattr(j_profile, "time_callable", fake(j_profile))
    return tr


def _shared(key):
    """The geometry both grids can hold: BSR keys compare without bd."""
    return key[:4]


def _search_pair(name, occ, kind_filter=None):
    """(port plan, jax plan, inputs) for the search tests."""
    from repro.pipeline.planner import plan_network as j_plan_network

    jg, tg, jp, tp, calib = _pruned(name) if occ == "pruned" else _setup(name)
    th = 0.75 if occ == "pruned" else occ
    plan = plan_network(tp, torch.from_numpy(calib), tg, occ_threshold=th, block_c=8)
    jplan = j_plan_network(jp, jnp.asarray(calib), jg, occ_threshold=th, block_c=8)
    assert [lp.impl for lp in plan.layers] == [lp.impl for lp in jplan.layers]
    return jg, tg, jp, tp, calib, plan, jplan


CASES = [(n, occ) for n in sorted(GRAPHS) for occ in (1.0, "pruned")]


@pytest.mark.parametrize("name,occ", CASES)
def test_search_layer_prices_shared_candidates_like_the_reference(
        name, occ, monkeypatch, reference_roofline):
    jg, tg, jp, tp, calib, plan, _ = _search_pair(name, occ)
    tr = _inject(monkeypatch, lambda key, layer: 100.0)
    xs = _layer_inputs(tg, tp, calib)
    n_shared = 0
    for lp, ju, tu, jw, tw, x in zip(plan.layers, jg.units(), tg.units(), jp["conv"],
                                     tp["conv"], xs):
        if not get_op(lp.kind, lp.impl).pallas:
            continue
        got = tilesearch.search_layer(tu, tw, x, lp.kind, lp.impl, tracer=tr)
        want = j_tilesearch.search_layer(ju, jw, jnp.asarray(x.numpy()), lp.kind, lp.impl,
                                         tracer=tr)
        ref = {}
        for cd in want.candidates:
            ref.setdefault(_shared(cd.key), cd.model_us)
        for cd in got.candidates:
            if _shared(cd.key) in ref:
                assert cd.model_us == pytest.approx(ref[_shared(cd.key)], rel=1e-9), cd.key
                n_shared += 1
        assert got.default.model_us == pytest.approx(want.default.model_us, rel=1e-9)
    assert n_shared > 0


def _timing_for():
    """Default 100 us; per layer, the first non-default candidate both grids
    hold (`chosen[layer]`) 50 us; every other candidate 150 us (slower than
    the default, so not eligible)."""
    chosen = {}

    def timing(key, layer):
        if layer in chosen and _shared(key) == chosen[layer]:
            return 50.0
        return 100.0 if not any(key) else 150.0

    return timing, chosen


@pytest.mark.parametrize("name,occ", CASES)
def test_injected_timings_give_the_reference_winners_and_db(
        name, occ, monkeypatch, reference_roofline):
    jg, tg, jp, tp, calib, plan, jplan = _search_pair(name, occ)
    timing, chosen = _timing_for()
    # make one shared geometry per kernel impl the fast one
    for lp, tu in zip(plan.layers, tg.units()):
        if get_op(lp.kind, lp.impl).pallas:
            cands = tilesearch.layer_tile_candidates(tu, lp.kind, lp.impl, 2)
            jc = {_shared(t.key()) for t in j_tilesearch.layer_tile_candidates(
                next(u for u in jg.units() if u.index == tu.index), lp.kind, lp.impl, 2)}
            fast = next((_shared(t.key()) for t in cands[1:] if _shared(t.key()) in jc), None)
            if fast is not None:
                chosen[tu.index] = fast
    tr = _inject(monkeypatch, timing)
    kw = dict(prune_factor=1e9, max_timed=100, tracer=tr)
    report, db = tilesearch.tile_search(plan, tp, torch.from_numpy(calib), **kw)
    jreport, jdb = j_tilesearch.tile_search(jplan, jp, jnp.asarray(calib),
                                            db=j_calibrate.CalibrationDB(device="cpu"), **kw)
    assert report.floor_holds() and jreport.floor_holds()
    assert len(report.layers) == len(jreport.layers)
    for a, b in zip(report.layers, jreport.layers):
        assert (a.index, a.kind, a.impl, a.shape_key) == (b.index, b.kind, b.impl, b.shape_key)
        assert _shared(a.best.key) == _shared(b.best.key)
        assert a.best.model_us == pytest.approx(b.best.model_us, rel=1e-9)
        assert a.best.measured_us == b.best.measured_us
        assert a.improved == b.improved
    assert {k: _shared(v) for k, v in db.tiles.items()} == \
        {k: _shared(v) for k, v in jdb.tiles.items()}
    # per-tile fits pool a geometry's timings over the layers that timed it:
    # compare the geometries both packages timed on the same layers
    def timed_on(rep):
        out: dict = {}
        for r in rep.layers:
            for cd in r.candidates:
                if cd.timed:
                    out.setdefault((r.kind, r.impl, _shared(cd.key)), set()).add(r.index)
        return out

    mine, theirs = timed_on(report), timed_on(jreport)
    same = {k for k in mine if theirs.get(k) == mine[k]}
    assert any(t == (0, 0, 0, 0) for (_, _, t) in same) or not db.entries
    n = 0
    for (d, k, i, t), e in db.entries.items():
        if (k, i, _shared(t)) in same:
            je = next(v for (jd, jk, ji, jt), v in jdb.entries.items()
                      if (jd, jk, ji, _shared(jt)) == (d, k, i, _shared(t)))
            assert e.scale == pytest.approx(je.scale, rel=1e-9)
            assert e.peak_flops == pytest.approx(je.peak_flops, rel=1e-9)
            assert e.n_samples == je.n_samples
            n += 1
    assert n == len(same)


def test_a_default_winner_erases_a_stale_entry(monkeypatch):
    _, tg, _, tp, calib = _setup("vgg-tiny")
    plan = plan_network(tp, torch.from_numpy(calib), tg, occ_threshold=1.0, block_c=8)
    lp = next(lp for lp in plan.layers if get_op(lp.kind, lp.impl).pallas)
    shape = calibrate.unit_shape_key(lp.to_unit())
    db = calibrate.CalibrationDB(device="cpu")
    db.put_tile(lp.kind, lp.impl, shape, TileConfig(block_c=16))
    tr = _inject(monkeypatch, lambda key, layer: 10.0 if not any(key) else 99.0)
    _, db = tilesearch.tile_search(plan, tp, torch.from_numpy(calib), db=db, tracer=tr)
    assert db.best_tile(lp.kind, lp.impl, shape) is None
    db.put_tile(lp.kind, lp.impl, shape, (0, 0, 0, 0, 0))  # all zero erases too
    assert not db.tiles


@pytest.mark.parametrize("occ", [1.0, "pruned"])
def test_tile_search_then_plan_closes_the_loop(occ):
    """Real timings on the host (plain versions): every kernel layer's
    stored winner is stamped on the plan, which runs to the same logits."""
    _, tg, _, tp, calib = _pruned("vgg-tiny") if occ == "pruned" else _setup("vgg-tiny")
    th = 0.75 if occ == "pruned" else occ
    x = torch.from_numpy(calib)
    plan = plan_network(tp, x, tg, occ_threshold=th, block_c=8)
    report, db = tilesearch.tile_search(plan, tp, x, iters=1, warmup=0, max_timed=2)
    assert report.floor_holds() and report.device_kind == "cpu"
    assert report.summary()["layers"] == len(plan.layers)
    tiled = plan_network(tp, x, tg, occ_threshold=th, block_c=8, tiles=db)
    for lp, r in zip(tiled.layers, report.layers):
        want = db.best_tile(lp.kind, lp.impl, r.shape_key)
        assert lp.tile == want
    fitted = {(k, i) for (_, k, i, _) in db.entries}
    assert fitted == {(lp.kind, lp.impl) for lp in plan.layers
                      if get_op(lp.kind, lp.impl).pallas}
    assert (plan_key(2, tiled) != plan_key(2, plan)) == any(lp.tile for lp in tiled.layers)
    got, want = run_plan(tiled, tp, x).numpy(), run_plan(plan, tp, x).numpy()
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= 1e-4 * scale + 1e-5 * min(1.0, scale)


@pytest.mark.parametrize("occ", [1.0, "pruned"])
def test_run_unit_at_every_card_geometry_matches_the_default(occ):
    """The plain versions at every geometry of the card's grid (and the
    reference's Pallas kernels in interpret mode at the default) agree
    within the fp32 limit."""
    jg, tg, jp, tp, calib = _pruned("vgg-tiny") if occ == "pruned" else _setup("vgg-tiny")
    xs = _layer_inputs(tg, tp, calib)
    n = 0
    for ju, tu, jw, tw, x in zip(jg.units(), tg.units(), jp["conv"], tp["conv"], xs):
        from repro_torch.graph.registry import unit_impl

        for family in ("ecr_pallas", "pecr_pallas", "bsr", "ecr_int8", "bsr_int8"):
            kind, impl = unit_impl(tu, family)
            base = run_unit(x, tw, tu, kind, impl, 8).numpy()
            scale = float(np.abs(base).max())
            lim = 1e-4 * scale + 1e-5 * min(1.0, scale)
            for t in tilesearch.layer_tile_candidates(tu, kind, impl, x.shape[0])[1:]:
                got = run_unit(x, tw, tu, kind, impl, 8, tile=t).numpy()
                if get_op(kind, impl).quantized and get_op(kind, impl).sparse:
                    # int8 ECR: another block_c schedules other blocks, but
                    # the same integers sum exactly
                    np.testing.assert_array_equal(got, base)
                else:
                    assert np.abs(got - base).max() <= lim, (kind, impl, t)
                n += 1
            if not get_op(kind, impl).quantized:
                want = np.asarray(j_run_unit(jnp.asarray(x.numpy()), jw, ju, kind, impl, 8))
                assert np.abs(base - want).max() <= lim
    assert n > 0


# ---------------------------------------------------------------------------
# autotune
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,grid", [
    ("vgg-tiny", dict(thresholds=(0.75, 0.99, 1.0), block_cs=(8,))),
    ("lenet-tiny", dict(thresholds=(1.0,), block_cs=(0, 8, 16))),
    ("alexnet-tiny", dict(thresholds=(1.0,), block_cs=(0, 8))),
])
def test_autotune_model_mode_matches_the_reference(name, grid, reference_roofline):
    """Every candidate plan holds a kernel layer here, where the reference
    models with the same roofline per layer (its all-dense plans go through
    XLA's HLO cost, which the port has not)."""
    jg, tg, jp, tp, calib = _setup(name)
    got = autotune(tp, torch.from_numpy(calib), tg, mode="model", **grid)
    want = j_autotune(jp, jnp.asarray(calib), jg, mode="model", mesh=None, **grid)
    assert all(c.plan.counts()["sparse"] + c.plan.counts()["bsr"] for c in got.candidates)
    assert [(c.occ_threshold, c.block_c) for c in got.candidates] == \
        [(c.occ_threshold, c.block_c) for c in want.candidates]
    assert [c.plan.counts() for c in got.candidates] == [c.plan.counts() for c in want.candidates]
    assert [c.model_us for c in got.candidates] == pytest.approx(
        [c.model_us for c in want.candidates], rel=1e-9)
    assert len({plan_key(2, c.plan) for c in got.candidates}) == \
        len({tuple((lp.kind, lp.impl) for lp in c.plan.layers) + (c.plan.block_c,)
             for c in want.candidates})
    assert (got.best.occ_threshold, got.best.block_c) == \
        (want.best.occ_threshold, want.best.block_c)
    assert got.used_model and want.used_model


def test_autotune_time_mode_picks_the_fastest_by_the_ports_clock(monkeypatch):
    _, tg, _, tp, calib = _setup("vgg-tiny")
    walls = iter([300.0, 100.0, 200.0, 400.0])

    def time_callable(f, *args, **kw):
        f(*args)  # the candidate runs once
        t = next(walls)
        return profile.TimingResult(median_us=t, spread=0.0, samples_us=(t,))

    monkeypatch.setattr(profile, "time_callable", time_callable)
    res = autotune(tp, torch.from_numpy(calib), tg, thresholds=(0.0, 0.5, 0.75, 1.0),
                   block_cs=(8,), mode="time")
    distinct = {plan_key(2, c.plan): c.wall_us for c in res.candidates}
    assert not res.used_model
    assert res.best.wall_us == min(distinct.values())
    assert all(c.model_us == float("inf") for c in res.candidates)
    assert res.plan is res.best.plan


@pytest.mark.parametrize("bt,bf", [(8, 16), (8, 32), (16, 64), (0, 0), (8, 4096)])
def test_sparse_matmul_tile_matches_the_reference(bt, bf):
    """The tile's bf is honoured by the reference's rule; its bt (the
    kernel's row block is 8) and bd (no counterpart) are not taken."""
    from repro.kernels.bsr_matmul.ops import sparse_matmul as j_sparse_matmul
    from repro_torch.kernels.bsr_matmul.ops import sparse_matmul

    rng = np.random.default_rng(bt + bf)
    h = rng.standard_normal((24, 100)).astype(np.float32)
    h[:8, 16:48] = 0.0
    h[8:, :64] = 0.0
    w = rng.standard_normal((100, 40)).astype(np.float32)
    got = sparse_matmul(torch.from_numpy(h), torch.from_numpy(w),
                        tile=TileConfig(bt=bt, bf=bf, bd=32)).numpy()
    want = np.asarray(j_sparse_matmul(jnp.asarray(h), jnp.asarray(w),
                                      tile=JTile(bt=bt, bf=bf, bd=32)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got, h @ w, rtol=1e-5, atol=1e-5 * np.abs(want).max())
