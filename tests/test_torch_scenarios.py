"""The port's telemetry and scenario library against the JAX package's,
mirroring tests/test_scenarios.py.

Arrivals, streams, event times and `dead_frac_at` are plain arithmetic on
`random.Random(seed)` in both packages, so they must be equal exactly. The
images are not: the port's `synth_image` draws from a `torch.Generator`, the
reference's from `jax.random`, and nothing tries to reproduce those bits. So
every replay held against the reference feeds BOTH engines the reference's
own `synth_image` output (as numpy), through a scenario that keeps the port
scenario's arrivals and events and swaps in the reference's images; the
weights are the reference's `init_cnn` values carried over as numpy.

On those replays, with the deterministic service model `sim_service_s`, the
port must give the reference's request ids, `t_arrival`, `t_formed`,
`t_done`, bucket sequence and re-plan events (kinds and times) exactly; its
logits within rtol=1e-4, atol=1e-5 (the fp32 depth tolerance of
tests/test_torch_planner.py), and the occupancy-EMA values and re-plan
deltas within abs=1e-6 (the planner parity's occupancy tolerance: the two
packages reduce the same live-block counts in float32 in another order)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.serving as J  # noqa: E402
import repro_torch.serving as T  # noqa: E402
from repro.configs.lenet import LENET_REDUCED as J_LENET_REDUCED  # noqa: E402
from repro.configs.vgg19_sparse import CNNConfig as JCNNConfig  # noqa: E402
from repro.graph import as_graph as j_as_graph  # noqa: E402
from repro.graph import init_graph as j_init_graph  # noqa: E402
from repro.models.cnn import init_cnn as j_init_cnn  # noqa: E402
from repro.pipeline import plan_network as j_plan_network  # noqa: E402
from repro.pipeline import run_plan as j_run_plan  # noqa: E402
from repro.sparse_weights import prune_graph_params as j_prune  # noqa: E402
from repro_torch.configs.lenet import LENET_REDUCED  # noqa: E402
from repro_torch.configs.vgg19_sparse import CNNConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.pipeline import plan_network, run_plan  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    DiurnalDriftScenario,
    Engine,
    HotSwapScenario,
    LatencyReservoir,
    ListScenario,
    MetricsTracker,
    MultiTenantScenario,
    PlanCache,
    PoissonBurstScenario,
    Scenario,
    ScenarioRequest,
    SimClock,
    TenantSpec,
    plan_key,
    replay_scenario,
    replay_stream,
    synth_image,
)

TINY = CNNConfig(name="vgg-serve-tiny", in_channels=16, img_size=12,
                 plan=((8, 1), (16, 1)), n_classes=4)
J_TINY = JCNNConfig(name="vgg-serve-tiny", in_channels=16, img_size=12,
                    plan=((8, 1), (16, 1)), n_classes=4)
SHAPE = (16, TINY.img_size, TINY.img_size)
SERVICE_S = 0.002  # deterministic service-time model for every sim replay
RTOL, ATOL = 1e-4, 1e-5  # fp32 logits, port vs reference
OCC_TOL = 1e-6  # occupancy-EMA values and re-plan deltas, port vs reference


@pytest.fixture(scope="module")
def params():
    """(reference params, port params): the reference's init_cnn values."""
    jp = j_init_cnn(jax.random.PRNGKey(0), J_TINY)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _ref_img(shape, seed, i, dead_frac=0.5) -> np.ndarray:
    return np.array(J.synth_image(shape, seed, i, dead_frac))


def _kw(dead_frac, seed, kw):
    kw.setdefault("calib", np.stack([_ref_img(SHAPE, seed, i, dead_frac)
                                     for i in range(2)]))
    kw.setdefault("occ_threshold", 0.9)
    kw.setdefault("block_c", 8)
    kw.setdefault("max_batch", 4)
    kw.setdefault("deadline_s", 0.005)
    kw.setdefault("sim_service_s", SERVICE_S)
    kw.setdefault("ema_alpha", 0.5)
    kw.setdefault("replan_band", 0.15)
    kw.setdefault("replan_cooldown", 0)
    return kw


def _engine(params, *, dead_frac=0.5, seed=900, clock=None, **kw):
    """The port's scenario engine planned at the `dead_frac` regime on a
    SimClock with the deterministic service model."""
    kw = _kw(dead_frac, seed, kw)
    kw["calib"] = torch.from_numpy(kw["calib"])
    return Engine(params[1], TINY, clock=clock or SimClock(), device="cpu", **kw)


def _j_engine(params, *, dead_frac=0.5, seed=900, clock=None, **kw):
    """The reference's engine, configured as `_engine`."""
    kw = _kw(dead_frac, seed, kw)
    kw["calib"] = jnp.asarray(kw["calib"])
    return J.Engine(params[0], J_TINY, clock=clock or J.SimClock(), **kw)


class _RefImages(Scenario):
    """A port scenario with its arrivals, streams and events kept and each
    request's image replaced by the reference scenario's (as a tensor)."""

    def __init__(self, port_scn, ref_scn):
        ours, theirs = port_scn.requests(), ref_scn.requests()
        assert [(r.t, r.stream) for r in ours] == [(r.t, r.stream) for r in theirs]
        self._reqs = [ScenarioRequest(t=a.t, stream=a.stream,
                                      img=torch.from_numpy(np.array(b.img)))
                      for a, b in zip(ours, theirs)]
        self.events = port_scn.events
        self.name = port_scn.name

    def requests(self) -> list:
        return list(self._reqs)


def _same_telemetry(tel, jtel):
    """The port's telemetry snapshot equals the reference's: counters and
    times exactly, occupancy values and deltas within OCC_TOL."""
    for k in set(tel) | set(jtel):
        if k == "occ_timeline":
            assert [t for t, _ in tel[k]] == [t for t, _ in jtel[k]]
            for (_, a), (_, b) in zip(tel[k], jtel[k]):
                np.testing.assert_allclose(a, b, rtol=0, atol=OCC_TOL)
        elif k == "replan_events":
            assert [{x: v for x, v in e.items() if x != "delta"} for e in tel[k]] == \
                [{x: v for x, v in e.items() if x != "delta"} for e in jtel[k]]
            for a, b in zip(tel[k], jtel[k]):
                if "delta" in a:
                    assert a["delta"] == pytest.approx(b["delta"], abs=OCC_TOL)
        else:
            assert tel.get(k) == jtel.get(k), k


def _same_results(res, jres):
    """Ids and timestamps exactly, logits within RTOL / ATOL."""
    assert [r.id for r in res] == [r.id for r in jres]
    for a, b in zip(res, jres):
        assert (a.t_arrival, a.t_formed, a.t_done) == (b.t_arrival, b.t_formed, b.t_done)
        np.testing.assert_allclose(a.logits, np.asarray(b.logits), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# MetricsTracker / LatencyReservoir
# ---------------------------------------------------------------------------


def test_latency_reservoir_percentiles_exact_when_unsaturated():
    r, jr = LatencyReservoir(size=256), J.LatencyReservoir(size=256)
    vals = [i / 1e3 for i in range(1, 101)]  # 1..100 ms, in seconds
    for v in vals:
        r.add(v)
        jr.add(v)
    p = r.percentiles_ms()
    assert p == jr.percentiles_ms()
    ref = np.array(vals) * 1e3
    assert p["count"] == 100
    assert p["mean_ms"] == pytest.approx(float(ref.mean()))
    for q in (50, 95, 99):
        assert p[f"p{q}_ms"] == pytest.approx(float(np.percentile(ref, q)))
    assert LatencyReservoir().percentiles_ms() == J.LatencyReservoir().percentiles_ms() == {
        "count": 0, "mean_ms": 0.0, "max_ms": 0.0, "p50_ms": 0.0, "p95_ms": 0.0,
        "p99_ms": 0.0}


def test_latency_reservoir_bounded_and_seed_deterministic():
    """Beyond `size` the sample is the reference's sample, value for value
    (the same algorithm R on the same `random.Random(seed)`)."""
    a, b = LatencyReservoir(size=8, seed=3), J.LatencyReservoir(size=8, seed=3)
    for i in range(1000):
        a.add(i * 1e-3)
        b.add(i * 1e-3)
    assert len(a.values) == 8 and a.count == 1000
    assert a.values == b.values
    assert a.percentiles_ms() == b.percentiles_ms()
    with pytest.raises(ValueError):
        LatencyReservoir(size=0)


def test_metrics_tracker_snapshot_counts_and_json():
    snaps = []
    for t in (MetricsTracker(), J.MetricsTracker()):
        t.on_submit(0.0)
        t.on_submit(0.001)
        t.on_batch(0.01, bucket=4, n_real=3, service_s=SERVICE_S)
        t.on_result(0.010)
        t.on_result(0.009)
        t.on_occupancy(0.01, np.array([0.5, 1.0]))
        t.on_replan_trigger(0.02, delta=0.3)
        t.on_replan_swap(0.03, changed=True)
        t.on_replan_error(0.04)
        t.on_hot_swap(0.05)
        t.on_verify_reject(0.06, ("RPA205",))
        snaps.append(t.snapshot())
    s, js = snaps
    assert s == js
    assert [e["kind"] for e in s["replan_events"]] == [
        "trigger", "swap", "error", "hot_swap", "verify_reject"]
    assert s["replans"] == {"triggers": 1, "swaps": 1, "errors": 1,
                            "hot_swaps": 1, "verify_rejects": 1}
    assert json.dumps(s) == json.dumps(js)


def test_metrics_tracker_timelines_are_bounded():
    snaps = []
    for t in (MetricsTracker(timeline_max=4), J.MetricsTracker(timeline_max=4)):
        for i in range(10):
            t.on_occupancy(float(i), [0.5])
            t.on_replan_trigger(float(i), 0.2)
        snaps.append(t.snapshot())
    assert snaps[0] == snaps[1]
    assert [row[0] for row in snaps[0]["occ_timeline"]] == [6.0, 7.0, 8.0, 9.0]
    assert snaps[0]["replans"]["triggers"] == 10


def test_engine_stats_latency_covers_flush_tail(params):
    """A lone request completed only by drain() reaches the percentile
    accounting in both packages, with the same latency and telemetry."""
    img = _ref_img(SHAPE, 1, 0)
    out = []
    for eng in (_engine(params), _j_engine(params)):
        eng.submit(img)
        eng.clock.advance(0.001)
        assert eng.poll() == []  # not due: nothing completed through poll
        results = eng.drain()
        assert len(results) == 1
        out.append((results, eng.stats()))
    (res, st), (jres, jst) = out
    _same_results(res, jres)
    assert st["lat_count"] == 1
    assert st["p50_ms"] == pytest.approx(res[0].latency_s * 1e3)
    for k in ("lat_count", "p50_ms", "p95_ms", "p99_ms", "mean_ms", "max_ms"):
        assert st[k] == jst[k], k
    _same_telemetry(st["telemetry"], jst["telemetry"])
    assert st["telemetry"]["bucket_counts"] == {"2": 1}  # min_bucket pad


# ---------------------------------------------------------------------------
# scenario definitions: arrivals equal the reference's, images seeded
# ---------------------------------------------------------------------------


def test_scenario_requests_deterministic_per_seed():
    def arrivals(mod, seed):
        return [r.t for r in mod.PoissonBurstScenario(
            in_shape=SHAPE, n_requests=12, seed=seed).requests()]

    for seed in (5, 6):
        assert arrivals(T, seed) == \
            arrivals(J, seed)
    ts = [r.t for r in PoissonBurstScenario(in_shape=SHAPE, n_requests=12,
                                            seed=5).requests()]
    assert ts != [r.t for r in PoissonBurstScenario(in_shape=SHAPE, n_requests=12,
                                                    seed=6).requests()]
    assert all(b > a for a, b in zip(ts, ts[1:]))  # strictly increasing
    a = PoissonBurstScenario(in_shape=SHAPE, n_requests=3, seed=5).requests()
    b = PoissonBurstScenario(in_shape=SHAPE, n_requests=3, seed=5).requests()
    for ra, rb in zip(a, b):
        assert torch.equal(ra.img, rb.img)
    # synth_image: a pure function of (seed, i, dead_frac), the trailing
    # dead band zeroed as in the reference
    img = synth_image(SHAPE, 5, 2, 0.5)
    assert torch.equal(img, synth_image(SHAPE, 5, 2, 0.5))
    assert not torch.equal(img, synth_image(SHAPE, 5, 3, 0.5))
    live = (img.abs().sum(dim=(1, 2)) > 0).numpy()
    jlive = np.asarray(jnp.abs(J.synth_image(SHAPE, 5, 2, 0.5)).sum(axis=(1, 2)) > 0)
    assert live.tolist() == jlive.tolist() == [True] * 8 + [False] * 8


def test_burst_rate_modulation():
    kw = dict(base_rps=50.0, burst_rps=800.0, burst_every_s=0.1, burst_len_s=0.03)
    s, js = PoissonBurstScenario(**kw), J.PoissonBurstScenario(**kw)
    for t in (0.0, 0.01, 0.029, 0.03, 0.05, 0.11, 0.2999, 1.0):
        assert s.rate_at(t) == js.rate_at(t)
    assert s.rate_at(0.01) == 800.0 and s.rate_at(0.05) == 50.0


def test_diurnal_dead_frac_profiles():
    for kw in (dict(dead_lo=0.5, dead_hi=0.0, drift="step", t_drift=0.05),
               dict(dead_lo=0.1, dead_hi=0.7, drift="sine", period_s=0.2)):
        s, js = DiurnalDriftScenario(**kw), J.DiurnalDriftScenario(**kw)
        for t in (0.0, 0.01, 0.049, 0.05, 0.1, 0.137, 0.2):
            assert s.dead_frac_at(t) == js.dead_frac_at(t)
    sine = DiurnalDriftScenario(dead_lo=0.1, dead_hi=0.7, drift="sine", period_s=0.2)
    assert sine.dead_frac_at(0.1) == pytest.approx(0.7)
    with pytest.raises(ValueError, match="drift"):
        DiurnalDriftScenario(drift="linear").dead_frac_at(0.0)
    # the diurnal stream: arrivals and each request's band as the reference's
    kw = dict(in_shape=SHAPE, n_requests=10, rate_rps=200.0, dead_lo=0.5,
              dead_hi=0.0, drift="step", t_drift=0.02, seed=3)
    ours = DiurnalDriftScenario(**kw).requests()
    theirs = J.DiurnalDriftScenario(**kw).requests()
    assert [r.t for r in ours] == [r.t for r in theirs]
    assert [bool(r.img[8:].abs().sum() == 0) for r in ours] == \
        [bool(jnp.abs(r.img[8:]).sum() == 0) for r in theirs]


def test_scenario_constructor_validation():
    with pytest.raises(ValueError, match="one arrival per image"):
        ListScenario(imgs=(1, 2), arrivals=(0.0,))
    with pytest.raises(ValueError, match="swap_fn"):
        HotSwapScenario(in_shape=SHAPE)
    s = ListScenario(imgs=("b", "a"), arrivals=(2.0, 1.0))
    assert [r.img for r in s.requests()] == ["a", "b"]
    assert s.streams() == J.ListScenario(imgs=("b", "a"), arrivals=(2.0, 1.0)).streams() \
        == ("",)
    tenants = (("x", TenantSpec(in_shape=SHAPE, n_requests=3, rate_rps=50.0)),
               ("y", TenantSpec(in_shape=(1, 8, 8), n_requests=2, rate_rps=80.0)))
    jtenants = tuple((k, J.TenantSpec(**vars(v))) for k, v in tenants)
    mt = MultiTenantScenario(tenants=tenants, seed=4)
    jmt = J.MultiTenantScenario(tenants=jtenants, seed=4)
    assert mt.streams() == jmt.streams() == ("x", "y")
    assert [(r.t, r.stream) for r in mt.requests()] == \
        [(r.t, r.stream) for r in jmt.requests()]
    hs = HotSwapScenario(in_shape=SHAPE, n_requests=4, t_swap=0.01, swap_fn=print)
    jhs = J.HotSwapScenario(in_shape=SHAPE, n_requests=4, t_swap=0.01, swap_fn=print)
    assert hs.events == jhs.events == ((0.01, print),)
    assert [r.t for r in hs.requests()] == [r.t for r in jhs.requests()]


def test_replay_scenario_validates_clock_and_streams(params):
    eng = _engine(params)
    other = _engine(params)  # its own SimClock: not shared
    with pytest.raises(ValueError, match="ONE shared"):
        replay_scenario({"a": eng, "b": other}, ListScenario(imgs=(), arrivals=()))
    with pytest.raises(ValueError, match="SimClock"):
        replay_scenario({"a": _Fake()}, ListScenario(imgs=(), arrivals=()))
    scn = ListScenario(imgs=(synth_image(SHAPE, 1, 0),), arrivals=(0.0,),
                       stream="ghost")
    with pytest.raises(ValueError, match="ghost"):
        replay_scenario(eng, scn)


class _Fake:
    """Engine stand-in whose clock is the (non-Sim) wall clock."""

    def __init__(self):
        import time

        self.clock = time.monotonic


# ---------------------------------------------------------------------------
# replay driver: wrapper equivalence + determinism, held against the reference
# ---------------------------------------------------------------------------


def test_replay_stream_is_thin_wrapper_over_replay_scenario(params):
    """replay_stream == replay_scenario over the same ListScenario in the
    port, and both equal the reference's replay of the same images."""
    imgs = [_ref_img(SHAPE, 3, i) for i in range(8)]
    rate = 300.0
    e1, e2, je = _engine(params), _engine(params), _j_engine(params)
    r1 = replay_stream(e1, [torch.from_numpy(x) for x in imgs], rate_rps=rate)
    arrivals = tuple(i / rate for i in range(len(imgs)))
    r2 = replay_scenario(e2, ListScenario(imgs=tuple(torch.from_numpy(x) for x in imgs),
                                          arrivals=arrivals))[""]
    assert [r.id for r in r1] == [r.id for r in r2]
    for a, b in zip(r1, r2):
        np.testing.assert_array_equal(a.logits, b.logits)
        assert (a.t_arrival, a.t_formed, a.t_done) == (b.t_arrival, b.t_formed, b.t_done)
    assert e1.stats()["telemetry"] == e2.stats()["telemetry"]
    jr = J.replay_stream(je, [jnp.asarray(x) for x in imgs], rate_rps=rate)
    _same_results(r1, jr)
    _same_telemetry(e1.stats()["telemetry"], je.stats()["telemetry"])


def _diurnal(mod, **kw):
    return mod.DiurnalDriftScenario(in_shape=SHAPE, n_requests=16, rate_rps=200.0,
                                    dead_lo=0.5, dead_hi=0.0, drift="step",
                                    t_drift=0.04, seed=7, **kw)


def test_seeded_replay_is_bit_identical_including_snapshot(params):
    """Two identical seeded replays in the port are bit-identical (logits
    and snapshot), and the replay equals the reference's."""
    def run():
        eng = _engine(params)
        scn = _RefImages(_diurnal(T),
                         _diurnal(J))
        return replay_scenario(eng, scn)[""], eng.stats()

    (r1, s1), (r2, s2) = run(), run()
    assert [r.id for r in r1] == [r.id for r in r2]
    for a, b in zip(r1, r2):
        np.testing.assert_array_equal(a.logits, b.logits)
        assert a.latency_s == b.latency_s
    assert s1["telemetry"] == s2["telemetry"] and s1["occ_ema"] == s2["occ_ema"]
    je = _j_engine(params)
    jr = J.replay_scenario(je, _diurnal(J))[""]
    _same_results(r1, jr)
    _same_telemetry(s1["telemetry"], je.stats()["telemetry"])


# ---------------------------------------------------------------------------
# the regime contracts
# ---------------------------------------------------------------------------


def test_diurnal_drift_replans_within_k_batches_to_reference_plan(params):
    """Planned at dead_lo, the traffic steps to dead_hi: the port re-plans
    within K batches of the onset, to the schedule plan_network picks at the
    drifted occupancy, at the same batch and to the same (kind, impl)
    decisions as the reference."""
    kw = dict(in_shape=SHAPE, n_requests=24, rate_rps=200.0, dead_lo=0.5,
              dead_hi=0.0, drift="step", t_drift=0.03, seed=5)
    scn, jscn = DiurnalDriftScenario(**kw), J.DiurnalDriftScenario(**kw)
    eng, je = _engine(params), _j_engine(params)
    key_before = plan_key(0, eng.plan)
    replay_scenario(eng, _RefImages(scn, jscn))
    J.replay_scenario(je, jscn)
    st, jst = eng.stats(), je.stats()
    assert st["replans"] == jst["replans"] >= 1
    tel = st["telemetry"]
    _same_telemetry(tel, jst["telemetry"])
    triggers = [e for e in tel["replan_events"] if e["kind"] == "trigger"]
    assert triggers and triggers[0]["delta"] > eng.replan_band
    k = sum(1 for t, _ in tel["occ_timeline"] if scn.t_drift <= t <= triggers[0]["t"])
    assert 1 <= k <= 4, f"re-plan took {k} post-drift batches"
    drifted = torch.from_numpy(np.stack([_ref_img(SHAPE, scn.seed, i, scn.dead_hi)
                                         for i in range(20, 24)]))
    ref = plan_network(params[1], drifted, eng.graph, occ_threshold=eng.plan.occ_threshold,
                       block_c=eng.plan.block_c, use_pallas=eng.use_pallas)
    assert plan_key(0, eng.plan) == plan_key(0, ref) != key_before
    assert [(lp.kind, lp.impl) for lp in eng.plan.layers] == \
        [(lp.kind, lp.impl) for lp in je.plan.layers]


def test_burst_never_strands_requests(params):
    """Every request served once, each formed within its deadline plus the
    backlog of buckets executed meanwhile, and the same formation times and
    buckets as the reference."""
    kw = dict(in_shape=SHAPE, n_requests=24, base_rps=50.0, burst_rps=2000.0,
              burst_every_s=0.08, burst_len_s=0.03, seed=11)
    scn, jscn = PoissonBurstScenario(**kw), J.PoissonBurstScenario(**kw)
    eng, je = _engine(params), _j_engine(params)
    results = replay_scenario(eng, _RefImages(scn, jscn))[""]
    jresults = J.replay_scenario(je, jscn)[""]
    assert sorted(r.id for r in results) == list(range(24))  # none lost/dup
    batch_times = sorted({r.t_formed for r in results})
    for r in results:
        backlog = sum(1 for t in batch_times if r.t_arrival < t < r.t_formed)
        bound = eng.batcher.deadline_s + backlog * SERVICE_S + 1e-9
        assert r.t_formed - r.t_arrival <= bound
    assert max(eng.metrics.bucket_counts) == eng.batcher.max_batch
    _same_results(results, jresults)
    _same_telemetry(eng.stats()["telemetry"], je.stats()["telemetry"])


def _lenet_params():
    jp = j_init_graph(jax.random.PRNGKey(1), J_LENET_REDUCED)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def test_multi_tenant_shared_cache_never_cross_contaminates(params):
    """Two models over ONE PlanCache: builds bounded by the distinct keys
    (warmup only), each tenant bitwise equal to its own model's run_plan,
    and the same build counts and logits as the reference."""
    lp = _lenet_params()
    lcalib = np.stack([_ref_img(LENET_REDUCED.in_shape, 901, i, 0.5) for i in range(2)])
    lkw = dict(occ_threshold=0.9, block_c=8, max_batch=4, deadline_s=0.005,
               sim_service_s=SERVICE_S, ema_alpha=0.5, replan_band=0.15,
               replan_cooldown=0)
    tenants = (("vgg", dict(in_shape=SHAPE, n_requests=6, rate_rps=100.0, dead_frac=0.5)),
               ("lenet", dict(in_shape=LENET_REDUCED.in_shape, n_requests=6,
                              rate_rps=100.0, dead_frac=0.5)))
    scn = MultiTenantScenario(tenants=tuple((k, TenantSpec(**v)) for k, v in tenants),
                              seed=13)
    jscn = J.MultiTenantScenario(tenants=tuple((k, J.TenantSpec(**v)) for k, v in tenants),
                                 seed=13)
    clock, cache = SimClock(), PlanCache(max_entries=32)
    engines = {"vgg": _engine(params, clock=clock, cache=cache),
               "lenet": Engine(lp[1], graph=LENET_REDUCED, calib=torch.from_numpy(lcalib),
                               clock=clock, cache=cache, device="cpu", **lkw)}
    jclock, jcache = J.SimClock(), J.PlanCache(max_entries=32)
    jengines = {"vgg": _j_engine(params, clock=jclock, cache=jcache),
                "lenet": J.Engine(lp[0], graph=J_LENET_REDUCED, calib=jnp.asarray(lcalib),
                                  clock=jclock, cache=jcache, **lkw)}
    warm = sum(e.warmup() for e in engines.values())
    assert warm == cache.compiles == len(cache._entries)  # all keys distinct
    assert warm == sum(e.warmup() for e in jengines.values())
    results = replay_scenario(engines, _RefImages(scn, jscn))
    jresults = J.replay_scenario(jengines, jscn)
    assert cache.compiles == warm == jcache.compiles  # zero stream builds
    for stream, eng in engines.items():
        assert eng.stats()["replans"] == 0
        tenant_imgs = [r.img for r in _RefImages(scn, jscn).requests()
                       if r.stream == stream]
        ref = run_plan(eng.plan, eng.params, torch.stack(tenant_imgs)).numpy()
        got = {r.id: r.logits for r in results[stream]}
        assert sorted(got) == list(range(len(tenant_imgs)))
        for i in range(len(tenant_imgs)):
            np.testing.assert_array_equal(got[i], ref[i])
        _same_results(results[stream], jresults[stream])


def _pruned(params, density):
    """The reference's pruned weights at `density`, for both packages."""
    jp, _ = j_prune(params[0], density, j_as_graph(J_TINY))
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def test_hot_swap_under_load_is_atomic(params):
    """Mid-stream swap to a BSR-pruned variant: requests done before the swap
    carry the old model's exact logits, those after the new model's, both
    variants' keys differ, and the port's results equal the reference's."""
    calib = np.stack([_ref_img(SHAPE, 900, i, 0.5) for i in range(2)])
    pruned = _pruned(params, 0.3)
    eng, je = _engine(params), _j_engine(params)
    plan_old, params_old = eng.plan, eng.params
    plan_new = plan_network(pruned[1], torch.from_numpy(calib), eng.graph,
                            occ_threshold=eng.plan.occ_threshold,
                            block_c=eng.plan.block_c, use_pallas=eng.use_pallas)
    jplan_new = j_plan_network(pruned[0], jnp.asarray(calib), je.graph,
                               occ_threshold=je.plan.occ_threshold,
                               block_c=je.plan.block_c, use_pallas=je.use_pallas)
    assert [(lp.kind, lp.impl) for lp in plan_new.layers] == \
        [(lp.kind, lp.impl) for lp in jplan_new.layers]
    kw = dict(in_shape=SHAPE, n_requests=16, rate_rps=200.0, t_swap=0.04, seed=17)
    scn = HotSwapScenario(swap_fn=lambda es: es[""].hot_swap(pruned[1], plan=plan_new), **kw)
    jscn = J.HotSwapScenario(swap_fn=lambda es: es[""].hot_swap(pruned[0], plan=jplan_new),
                             **kw)
    mapped = _RefImages(scn, jscn)
    results = replay_scenario(eng, mapped)[""]
    jresults = J.replay_scenario(je, jscn)[""]
    assert sorted(r.id for r in results) == list(range(16))
    st = eng.stats()
    assert st["hot_swaps"] == 1 and st["plan_bsr"] >= 1
    swap_t = [e for e in st["telemetry"]["replan_events"] if e["kind"] == "hot_swap"][0]["t"]
    imgs = torch.stack([r.img for r in mapped.requests()])  # id == arrival order
    ref_old = run_plan(plan_old, params_old, imgs).numpy()
    ref_new = run_plan(plan_new, pruned[1], imgs).numpy()
    pre = [r for r in results if r.t_done <= swap_t]
    post = [r for r in results if r.t_done > swap_t]
    assert pre and post, "t_swap must land mid-stream to test atomicity"
    for r in pre:
        np.testing.assert_array_equal(r.logits, ref_old[r.id])
    for r in post:
        np.testing.assert_array_equal(r.logits, ref_new[r.id])
    assert plan_key(0, plan_new) != plan_key(0, plan_old)
    _same_results(results, jresults)
    _same_telemetry(st["telemetry"], je.stats()["telemetry"])
    jref = np.asarray(j_run_plan(jplan_new, pruned[0], jnp.asarray(imgs.numpy())))
    np.testing.assert_allclose(ref_new, jref, rtol=RTOL, atol=ATOL)


def test_hot_swap_before_first_batch_requires_calib(params):
    eng, je = _engine(params), _j_engine(params)
    with pytest.raises(ValueError, match="hot_swap"):
        eng.hot_swap(params[1])  # no executed batch yet: no recent calib
    with pytest.raises(ValueError, match="hot_swap"):
        je.hot_swap(params[0])
    calib = np.stack([_ref_img(SHAPE, 900, i, 0.5) for i in range(2)])
    assert eng.hot_swap(params[1], calib=torch.from_numpy(calib)) is True
    je.hot_swap(params[0], calib=jnp.asarray(calib))
    assert eng.n_hot_swaps == je.n_hot_swaps == 1
    assert eng.stats()["telemetry"]["replans"]["hot_swaps"] == 1
    assert [(lp.kind, lp.impl) for lp in eng.plan.layers] == \
        [(lp.kind, lp.impl) for lp in je.plan.layers]
    # a swapped-in params tree must already live on the engine's device
    meta = {
        "stages": [[w.to("meta") for w in ws] for ws in params[1]["stages"]],
        "fc1": params[1]["fc1"].to("meta"), "fc2": params[1]["fc2"].to("meta")}
    with pytest.raises(ValueError, match="params live on"):
        eng.hot_swap(meta, plan=eng.plan)
    assert eng.n_hot_swaps == 1
