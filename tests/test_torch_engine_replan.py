"""The port's re-plan hysteresis and hot swap against the JAX package's,
mirroring tests/test_engine_replan.py: EMA convergence at the configured
ema_alpha, cooldown after a swap, the async swap landing only between
batches, failed re-plans counted without killing serving, and the hot-swap
generation bump dropping a stale in-flight re-plan. Plus the plan cache's
weight signature: two pruned variants with the same (kind, impl) decisions
served one after the other through `hot_swap` each run under their own
runner and plan.

Each test drives `_observe` / `_launch_replan` / `_adopt_pending_plan`
directly, or gates the module-level `plan_network` on an event, so every
interleaving is deterministic. Both packages get the reference's `init_cnn`
weights and `synth_image` images as numpy; the port's engine logits are held
bitwise against its own `run_plan`, its scripted EMA against the reference's
at rtol=1e-12 (the same float64 arithmetic on the same float32 inputs), and
its plans' (kind, impl) decisions and weight signatures equal the
reference's."""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.serving as J  # noqa: E402
from repro.configs.vgg19_sparse import CNNConfig as JCNNConfig  # noqa: E402
from repro.graph import as_graph as j_as_graph  # noqa: E402
from repro.models.cnn import init_cnn as j_init_cnn  # noqa: E402
from repro.pipeline import plan_network as j_plan_network  # noqa: E402
from repro.sparse_weights import prune_graph_params as j_prune  # noqa: E402
from repro_torch.configs.vgg19_sparse import CNNConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.graph import as_graph  # noqa: E402
from repro_torch.pipeline import plan_network, run_plan  # noqa: E402
from repro_torch.serving import Engine, SimClock, plan_key  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402

TINY = CNNConfig(name="vgg-serve-tiny", in_channels=16, img_size=12,
                 plan=((8, 1), (16, 1)), n_classes=4)
J_TINY = JCNNConfig(name="vgg-serve-tiny", in_channels=16, img_size=12,
                    plan=((8, 1), (16, 1)), n_classes=4)
SHAPE = (16, TINY.img_size, TINY.img_size)


@pytest.fixture(scope="module")
def params():
    """(reference params, port params): the reference's init_cnn values."""
    jp = j_init_cnn(jax.random.PRNGKey(0), J_TINY)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _img(seed, i=0, dead_frac=0.5) -> np.ndarray:
    return np.array(J.synth_image(SHAPE, seed, i, dead_frac))


def _calib() -> np.ndarray:
    return np.stack([_img(900, i) for i in range(2)])


def _engine(params, **kw):
    kw.setdefault("calib", torch.from_numpy(_calib()))
    kw.setdefault("occ_threshold", 0.9)
    kw.setdefault("block_c", 8)
    kw.setdefault("max_batch", 4)
    kw.setdefault("deadline_s", 0.005)
    kw.setdefault("clock", SimClock())
    kw.setdefault("sim_service_s", 0.002)
    return Engine(params[1], TINY, device="cpu", **kw)


def _j_engine(params, **kw):
    kw.setdefault("calib", jnp.asarray(_calib()))
    kw.setdefault("occ_threshold", 0.9)
    kw.setdefault("block_c", 8)
    kw.setdefault("max_batch", 4)
    kw.setdefault("deadline_s", 0.005)
    kw.setdefault("clock", J.SimClock())
    kw.setdefault("sim_service_s", 0.002)
    return J.Engine(params[0], J_TINY, **kw)


def _dense(seed) -> np.ndarray:
    """A fully-dense request image: entry occupancy 1.0, far from the 0.5
    regime the engine planned at — the drift driver."""
    return _img(seed, 0, 0.0)


def _run_plan(plan, params, imgs) -> np.ndarray:
    return run_plan(plan, params, torch.from_numpy(np.stack(imgs))).numpy()


def _decisions(plan) -> list:
    return [(lp.kind, lp.impl) for lp in plan.layers]


def test_ema_convergence_matches_alpha(params):
    """k scripted observations of a constant target converge the EMA as
    target + (start - target) * (1 - alpha)^k, and as the reference's."""
    a = 0.3
    eng = _engine(params, ema_alpha=a, replan_band=10.0)  # band: never trigger
    je = _j_engine(params, ema_alpha=a, replan_band=10.0)
    np.testing.assert_allclose(eng._occ_ema, je._occ_ema, rtol=0, atol=1e-6)
    start = eng._occ_ema.copy()
    target = np.full_like(start, 0.95)
    for k in range(1, 6):
        eng._observe(target.copy())
        je._observe(target.copy())
        expect = target + (start - target) * (1.0 - a) ** k
        np.testing.assert_allclose(eng._occ_ema, expect, rtol=1e-12)
        np.testing.assert_allclose(eng._occ_ema, je._occ_ema, rtol=0, atol=1e-6)
    assert eng.n_replans == je.n_replans == 0
    assert len(eng.metrics.occ_timeline) == len(je.metrics.occ_timeline) == 5


def test_replan_cooldown_suppresses_triggers(params):
    """After a swap the detector holds fire for replan_cooldown
    observations even far outside the band, as the reference's does."""
    fired = []
    for eng in (_engine(params, ema_alpha=1.0, replan_band=0.05, replan_cooldown=3),
                _j_engine(params, ema_alpha=1.0, replan_band=0.05, replan_cooldown=3)):
        launches = []
        eng._launch_replan = lambda e=eng, out=launches: out.append(e.clock())
        eng._pending_plan = eng.plan  # an adopted re-plan of the same schedule
        eng._adopt_pending_plan()
        assert eng.n_replans == 0 and eng._cooldown == 3
        far = np.zeros_like(eng._occ_ema)  # delta 0.5+: far outside the band
        for _ in range(3):
            eng._observe(far)
            assert launches == []  # cooldown ticks down, no launch
        eng._observe(far)
        assert len(launches) == 1 and eng.metrics.replan_triggers == 1
        fired.append(len(launches))
    assert fired[0] == fired[1]


def test_async_replan_swap_is_atomic_between_batches(params):
    """While a background re-plan is in flight every batch keeps the old
    plan's bit-exact logits; the new plan lands at the next poll() and has
    the reference's decisions."""
    eng = _engine(params, ema_alpha=1.0, replan_band=0.1, replan_cooldown=0,
                  replan_async=True)
    plan_old = eng.plan
    release = threading.Event()
    real_plan_network = engine_mod.plan_network

    def gated(*args, **kw):
        release.wait(30)
        return real_plan_network(*args, **kw)

    engine_mod.plan_network = gated
    try:
        batch1 = [_dense(i) for i in range(4)]
        out1 = eng.serve(batch1)  # dense batch: EMA jumps, trigger fires
        assert eng._replanning and eng.n_replans == 0
        np.testing.assert_array_equal(out1, _run_plan(plan_old, params[1], batch1))
        batch2 = [_dense(10 + i) for i in range(4)]
        out2 = eng.serve(batch2)  # re-plan still in flight: old plan serves
        assert eng.plan is plan_old
        np.testing.assert_array_equal(out2, _run_plan(plan_old, params[1], batch2))
        release.set()
        eng.join_replan()
    finally:
        engine_mod.plan_network = real_plan_network
    assert eng._replan_thread is not None and not eng._replan_thread.is_alive()
    assert eng.poll() == []  # adoption point: swaps the finished plan in
    assert eng.n_replans == 1
    assert plan_key(0, eng.plan) != plan_key(0, plan_old)
    batch3 = [_dense(20 + i) for i in range(4)]
    np.testing.assert_array_equal(eng.serve(batch3), _run_plan(eng.plan, params[1], batch3))
    swaps = [e for e in eng.metrics.replan_events if e["kind"] == "swap"]
    assert len(swaps) == 1 and swaps[0]["changed"]
    je = _j_engine(params, ema_alpha=1.0, replan_band=0.1, replan_cooldown=0)
    je.serve([jnp.asarray(x) for x in batch1])  # synchronous re-plan
    assert je.n_replans == 1 and _decisions(je.plan) == _decisions(eng.plan)


def test_replan_error_counts_without_killing_serving(params):
    """A failing plan_network neither wedges the drift detector nor drops
    the batch that triggered it; the next healthy trigger re-plans."""
    eng = _engine(params, ema_alpha=1.0, replan_band=0.1, replan_cooldown=0)
    plan_old = eng.plan
    real_plan_network = engine_mod.plan_network

    def boom(*args, **kw):
        raise RuntimeError("planner outage")

    engine_mod.plan_network = boom
    try:
        for round_ in range(2):
            batch = [_dense(round_ * 10 + i) for i in range(4)]
            out = eng.serve(batch)  # trigger -> work() raises -> batch survives
            np.testing.assert_array_equal(out, _run_plan(plan_old, params[1], batch))
        assert eng.replan_errors == 2 and eng.n_replans == 0
        assert eng.plan is plan_old and not eng._replanning
    finally:
        engine_mod.plan_network = real_plan_network
    out = eng.serve([_dense(30 + i) for i in range(4)])  # healthy again
    assert out.shape == (4, 4)
    assert eng.n_replans == 1
    assert eng.stats()["replan_errors"] == 2
    kinds = [e["kind"] for e in eng.metrics.replan_events]
    assert kinds.count("error") == 2 and kinds.count("swap") == 1


def test_hot_swap_drops_stale_inflight_replan(params):
    """A hot_swap landing while a background re-plan is in flight bumps the
    plan generation: the stale result is dropped on arrival, never adopted
    over the new model, and the detector is unwedged."""
    eng = _engine(params, ema_alpha=1.0, replan_band=0.1, replan_cooldown=0,
                  replan_async=True)
    swap_calib = np.stack([_dense(50), _dense(51)])
    swap_plan = plan_network(params[1], torch.from_numpy(swap_calib), eng.graph,
                             occ_threshold=eng.plan.occ_threshold,
                             block_c=eng.plan.block_c, use_pallas=eng.use_pallas)
    jswap = j_plan_network(params[0], jnp.asarray(swap_calib), j_as_graph(J_TINY),
                           occ_threshold=0.9, block_c=8)
    assert _decisions(swap_plan) == _decisions(jswap)
    release = threading.Event()
    real_plan_network = engine_mod.plan_network

    def gated(*args, **kw):
        release.wait(30)
        return real_plan_network(*args, **kw)

    engine_mod.plan_network = gated
    try:
        eng.serve([_dense(i) for i in range(4)])  # drift: background re-plan
        assert eng._replanning
        assert eng.hot_swap(params[1], plan=swap_plan) is True  # bumps the gen
        release.set()
        eng.join_replan()
    finally:
        engine_mod.plan_network = real_plan_network
    assert not eng._replan_thread.is_alive()
    assert eng.poll() == []  # adoption point: nothing pending to adopt
    assert eng.plan is swap_plan  # the stale result did NOT clobber the swap
    assert eng._pending_plan is None and not eng._replanning
    assert eng.n_replans == 0 and eng.n_hot_swaps == 1
    out = eng.serve([_dense(60 + i) for i in range(4)])
    assert out.shape == (4, 4)


def test_hot_swap_recenters_ema_and_arms_cooldown(params):
    eng = _engine(params, replan_cooldown=2)
    je = _j_engine(params, replan_cooldown=2)
    batch = [_img(7, i, 0.5) for i in range(4)]
    eng.serve(batch)
    je.serve([jnp.asarray(x) for x in batch])
    eng.hot_swap(eng.params)  # re-plans on the most recent real batch
    je.hot_swap(je.params)
    np.testing.assert_array_equal(
        eng._occ_ema, np.array([lp.occupancy for lp in eng.plan.layers]))
    assert eng._cooldown == je._cooldown == 2
    assert eng.n_hot_swaps == je.n_hot_swaps == 1
    np.testing.assert_allclose(eng._occ_ema, je._occ_ema, rtol=0, atol=1e-6)
    assert _decisions(eng.plan) == _decisions(je.plan)
    assert eng.stats()["hot_swaps"] == je.stats()["hot_swaps"] == 1


# ---------------------------------------------------------------------------
# PlanKey.weight_sig: pruned variants never share a runner
# ---------------------------------------------------------------------------

DENSITIES = (0.3, 0.5)  # same (kind, impl) decisions on the tiny CNN


def _variants(params):
    """{density: (ref params, port params, port plan, ref plan)}: the
    reference's magnitude pruning at each density, planned in both packages
    on the same calibration images."""
    jgraph = j_as_graph(J_TINY)
    out = {}
    for d in DENSITIES:
        jp, _ = j_prune(params[0], d, jgraph)
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        plan = plan_network(tp, torch.from_numpy(_calib()), as_graph(TINY),
                            occ_threshold=0.9, block_c=8)
        jplan = j_plan_network(jp, jnp.asarray(_calib()), jgraph, occ_threshold=0.9,
                               block_c=8)
        out[d] = (jp, tp, plan, jplan)
    return out


def test_plan_key_weight_sig_matches_reference(params):
    """weight_sig lists (layer index, density to 2 dp) of each BSR layer,
    as the reference's; a dense plan's key has none."""
    for d, (_, _, plan, jplan) in _variants(params).items():
        key, jkey = plan_key(4, plan), J.plan_key(4, jplan)
        assert key.weight_sig == jkey.weight_sig != ()
        assert key.occ_sig == jkey.occ_sig
        assert all(w == round(lp.weight_density, 2) for (i, w), lp in
                   zip(key.weight_sig, [plan.layers[i] for i, _ in key.weight_sig]))
    dense = _engine(params).plan
    assert plan_key(4, dense).weight_sig == ()


def test_hot_swap_between_pruned_variants_builds_separate_runners(params):
    """The 0.3- and 0.5-pruned variants plan the same (kind, impl)
    decisions; served one after the other through hot_swap, each runs under
    its own runner and plan (logits bitwise equal to its own run_plan), and
    swapping back builds nothing. Without the weight signature both share
    one key, and the second model runs under the first one's runner."""
    v = _variants(params)
    (_, p3, plan3, _), (_, p5, plan5, _) = v[0.3], v[0.5]
    assert _decisions(plan3) == _decisions(plan5)
    assert [lp.impl for lp in plan3.layers].count("bsr") >= 1
    eng = _engine(params)
    imgs = [_img(33, i) for i in range(4)]
    for p, plan in ((p3, plan3), (p5, plan5)):
        assert eng.hot_swap(p, plan=plan) is True
        np.testing.assert_array_equal(eng.serve(imgs), _run_plan(plan, p, imgs))
    assert plan_key(4, plan3) != plan_key(4, plan5)
    builds = eng.cache.compiles
    assert builds == 2  # one bucket-4 runner per variant
    assert eng.hot_swap(p3, plan=plan3) is True
    np.testing.assert_array_equal(eng.serve(imgs), _run_plan(plan3, p3, imgs))
    assert eng.cache.compiles == builds and eng.n_hot_swaps == 3
