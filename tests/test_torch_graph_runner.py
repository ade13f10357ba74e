"""The compiled CNN runner (`repro_torch.serving.graph_runner.CompiledRunner`)
on the host, where it keeps the card's static buffers and runs its body
eagerly on them.

- Its logits are bitwise equal to `run_plan` on the same bucket and its
  occupancies bitwise equal to `run_plan(collect_occupancy=True,
  n_valid=...)`, for every variant of the tiny VGG the serving tests use
  (dense-weight ECR / PECR, ECR + dense, pruned BSR, int8, pruned int8) at
  buckets 2, 4 and 8, with `n_valid` changing between calls on one runner.
- The slice against the reference: the runner's logits against the JAX
  package's AOT-compiled `_make_runner` (Pallas in interpret mode) at
  rtol 1e-4 + atol 1e-5 (the planner tests' fp32 limit) and its occupancies
  at 1e-6, on the reference's own params and images.
- `occupancy_stat` with a 0-dim tensor `n_valid` equals the JAX package's
  at 0, 1, N and N+3, exactly: the per-sample occupancies are quarters (4
  channel blocks), whose sums and quotients both packages round alike.
- A result is not overwritten by the next call; `assert_plan_ok` runs once
  per build and never per batch; a failing capture propagates out of
  `Engine.serve` with no eager fallback; same-key hot swaps (VGG-tiny
  pruned to 0.25 and 0.3, a dense-weight swap under the same plan) serve
  each params' own `run_plan` logits without a build.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graph import init_graph as j_init_graph  # noqa: E402
from repro.launch.serve_cnn import serving_graph as j_serving_graph  # noqa: E402
from repro.launch.serve_cnn import synth_requests as j_synth  # noqa: E402
from repro.models.cnn import shift_dead_channels as j_shift  # noqa: E402
from repro.pipeline.planner import occupancy_stat as j_occupancy_stat  # noqa: E402
from repro.pipeline.planner import plan_network as j_plan_network  # noqa: E402
from repro.serving.engine import _make_runner as j_make_runner  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.graph import init_graph  # noqa: E402
from repro_torch.launch.serve_cnn import serving_graph, synth_requests  # noqa: E402
from repro_torch.models.cnn import shift_dead_channels  # noqa: E402
from repro_torch.pipeline import occupancy_stat, plan_network, run_plan  # noqa: E402
from repro_torch.serving import Engine, SimClock, plan_key  # noqa: E402
from repro_torch.serving.graph_runner import CompiledRunner  # noqa: E402
from repro_torch.sparse_weights.prune import prune_graph_params  # noqa: E402

GRAPH = serving_graph("vgg19")  # VGG-tiny: 16x16x16, convs 16/16/32

# variant -> (prune density, int8, occ_threshold, the plan it must give)
VARIANTS = {
    "ecr-pecr": (1.0, False, 1.0, ["ecr_pallas", "pecr_pallas", "pecr_pallas"]),
    "ecr-dense": (1.0, False, 0.75, ["ecr_pallas", "dense", "dense"]),
    "pruned": (0.3, False, 1.0, ["bsr", "pecr_pallas", "pecr_pallas"]),
    "int8": (1.0, True, 1.0, ["ecr_int8", "ecr_int8", "ecr_int8"]),
    "pruned-int8": (0.3, True, 1.0, ["bsr_int8", "pecr_pallas", "pecr_pallas"]),
}

_CACHE: dict = {}


def _params(seed=0):
    return shift_dead_channels(init_graph(torch.Generator().manual_seed(seed), GRAPH,
                                          device="cpu"))


def _calib():
    return torch.stack(synth_requests(GRAPH, 2, seed=1, device="cpu"))


def _variant(name):
    """(params, plan) of one variant, built once."""
    if name not in _CACHE:
        density, int8, th, want = VARIANTS[name]
        params = _params()
        if density < 1.0:
            params, _ = prune_graph_params(params, density, GRAPH)
        plan = plan_network(params, _calib(), GRAPH, occ_threshold=th, block_c=8,
                            int8=int8, int8_budget=0.0)
        assert [lp.impl for lp in plan.layers] == want
        _CACHE[name] = (params, plan)
    return _CACHE[name]


def _batch(n, seed):
    """n requests at mixed dead fractions (the all-dead tail of a padded
    bucket included)."""
    imgs = [synth_requests(GRAPH, 1, seed=seed + i, dead_frac=(0.25, 0.5, 0.75)[i % 3],
                           device="cpu")[0] for i in range(n)]
    imgs[-1] = torch.zeros_like(imgs[-1])
    return torch.stack(imgs)


def _engine(params, **kw):
    kw.setdefault("calib", _calib())
    kw.setdefault("occ_threshold", 1.0)
    kw.setdefault("block_c", 8)
    kw.setdefault("max_batch", 4)
    kw.setdefault("deadline_s", 0.005)
    kw.setdefault("clock", SimClock())
    return Engine(params, graph=GRAPH, device="cpu", **kw)


@pytest.mark.parametrize("bucket", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_runner_equals_run_plan_bitwise(name, bucket):
    params, plan = _variant(name)
    imgs = _batch(bucket, seed=10 * bucket)
    runner = CompiledRunner(plan, params, bucket, "cpu")
    want = run_plan(plan, params, imgs)
    order = [bucket] + list(range(1, bucket)) + [0]
    for nv in order:
        logits, occs = runner(params, imgs, nv)
        ref_logits, ref_occs = run_plan(plan, params, imgs, collect_occupancy=True,
                                        n_valid=nv)
        assert torch.equal(logits, want) and torch.equal(logits, ref_logits), nv
        assert torch.equal(occs, ref_occs), (nv, occs, ref_occs)
    logits, occs = runner(params, imgs, torch.tensor(1, dtype=torch.int32))
    assert torch.equal(occs, run_plan(plan, params, imgs, collect_occupancy=True,
                                      n_valid=1)[1])


@pytest.mark.parametrize("bucket", [2, 4])
@pytest.mark.parametrize("occ_threshold", [0.75, 1.0])
def test_runner_matches_the_reference_compiled_runner(occ_threshold, bucket):
    """The port's runner against the reference's AOT-compiled whole-batch
    executor, on the reference's params and images."""
    jg = j_serving_graph("vgg19")
    jp = j_shift(j_init_graph(jax.random.PRNGKey(0), jg))
    calib = np.stack([np.asarray(x) for x in j_synth(jg, 2, seed=1)])
    imgs = np.stack([np.asarray(x) for x in j_synth(jg, bucket, seed=5)])
    imgs[-1] = 0.0
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    jplan = j_plan_network(jp, jnp.asarray(calib), jg, occ_threshold=occ_threshold,
                           block_c=8)
    plan = plan_network(tp, torch.from_numpy(calib), GRAPH,
                        occ_threshold=occ_threshold, block_c=8)
    assert [lp.impl for lp in plan.layers] == [lp.impl for lp in jplan.layers]
    nv_s = jax.ShapeDtypeStruct((), jnp.int32)
    exe = jax.jit(j_make_runner(jplan)).lower(
        jp, jax.ShapeDtypeStruct(imgs.shape, jnp.float32), nv_s).compile()
    runner = CompiledRunner(plan, tp, bucket, "cpu")
    for nv in (bucket, 1):
        jl, jo = exe(jp, jnp.asarray(imgs), jnp.int32(nv))
        logits, occs = runner(tp, torch.from_numpy(imgs), nv)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(occs.numpy(), np.asarray(jo), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_valid", [0, 1, 5, 8])
def test_occupancy_stat_with_a_tensor_count_matches_the_reference(n_valid):
    """N = 5 samples of 32 channels at block_c 8, n_valid at 0, 1, N, N+3."""
    rng = np.random.default_rng(n_valid)
    x = rng.random((5, 32, 6, 6), dtype=np.float32)
    x *= rng.random((5, 32, 1, 1)) > 0.6
    want = float(j_occupancy_stat(jnp.asarray(x), 8, n_valid=jnp.int32(n_valid)))
    got = occupancy_stat(torch.from_numpy(x), 8,
                         n_valid=torch.tensor(n_valid, dtype=torch.int32))
    assert got.dtype == torch.float32 and got.ndim == 0
    assert float(got) == want
    assert float(occupancy_stat(torch.from_numpy(x), 8, n_valid=n_valid)) == want


def test_a_result_survives_the_next_call():
    params, plan = _variant("ecr-pecr")
    runner = CompiledRunner(plan, params, 4, "cpu")
    a, b = _batch(4, seed=1), _batch(4, seed=2)
    la, oa = runner(params, a, 3)
    kept = (la.clone(), oa.clone())
    lb, ob = runner(params, b, 1)
    assert not torch.equal(la, lb)
    assert torch.equal(la, kept[0]) and torch.equal(oa, kept[1])


def test_the_plan_is_verified_once_per_build_never_per_batch(monkeypatch):
    import repro_torch.analysis as analysis

    params, plan = _variant("pruned")
    eng = _engine(params, plan=plan, replan_band=10.0)  # no re-plan: it plans, and verifies
    calls = []
    real = analysis.assert_plan_ok

    def counting(plan, params=None, **kw):
        calls.append(params is not None)
        return real(plan, params, **kw)

    monkeypatch.setattr(analysis, "assert_plan_ok", counting)
    builds = eng.warmup()
    assert builds == len(eng.batcher.exec_buckets()) == 2
    assert calls.count(True) == builds  # the runner's check, with the params
    del calls[:]
    for n in (1, 2, 3, 4, 4, 2):
        eng.serve(list(_batch(n, seed=n)))
    assert calls == [] and eng.cache.compiles == builds


def test_a_failed_capture_propagates_out_of_serve(monkeypatch):
    params, plan = _variant("ecr-pecr")
    eng = _engine(params, plan=plan)

    def refuse(self):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(CompiledRunner, "_capture", refuse)
    for _ in range(2):  # nothing was cached: the second try raises as well
        with pytest.raises(RuntimeError, match="capturing") as err:
            eng.serve(list(_batch(2, seed=3)))
        assert any("while capturing the runner of PlanKey(bucket=2" in n
                   for n in err.value.__notes__)
    assert eng.n_batches == 0 and eng.cache.compiles == 0


def test_same_key_hot_swaps_serve_each_params_own_logits():
    """VGG-tiny pruned to 0.25 and to 0.3 plan one key; a dense-weight
    model and another one share a plan. Each swap lands with one weight
    copy and no build, and every batch equals its own params' run_plan."""
    base = _params()
    p25, _ = prune_graph_params(base, 0.25, GRAPH)
    p30, _ = prune_graph_params(base, 0.3, GRAPH)
    plan25 = plan_network(p25, _calib(), GRAPH, occ_threshold=1.0, block_c=8)
    plan30 = plan_network(p30, _calib(), GRAPH, occ_threshold=1.0, block_c=8)
    assert plan_key(4, plan25) == plan_key(4, plan30)
    eng = _engine(p30, plan=plan30)
    assert eng.warmup() == 2
    imgs = list(_batch(4, seed=40))
    slots = eng._executable(4).slots
    served = {}
    for name, p, plan, copied in (("0.3", p30, plan30, 0), ("0.25", p25, plan25, 1),
                                  ("0.3", p30, plan30, 1)):
        builds, copies = eng.cache.compiles, slots.copies
        assert eng.hot_swap(p, plan=plan) is True
        assert eng.cache.compiles == builds and slots.copies == copies + copied
        served[name] = eng.serve(imgs)
        np.testing.assert_array_equal(served[name],
                                      run_plan(plan, p, torch.stack(imgs)).numpy())
    assert not np.array_equal(served["0.3"], served["0.25"])

    d1, d2 = _params(0), _params(1)
    dplan = plan_network(d1, _calib(), GRAPH, occ_threshold=1.0, block_c=8)
    eng = _engine(d1, plan=dplan)
    eng.warmup()
    before = eng.serve(imgs)
    builds = eng.cache.compiles
    assert eng.hot_swap(d2, plan=dplan) is True
    after = eng.serve(imgs)
    assert eng.cache.compiles == builds
    np.testing.assert_array_equal(before, run_plan(dplan, d1, torch.stack(imgs)).numpy())
    np.testing.assert_array_equal(after, run_plan(dplan, d2, torch.stack(imgs)).numpy())
    assert not np.array_equal(before, after)


def test_a_new_key_is_built_at_the_swap_not_in_a_batch():
    """A hot swap to a plan of another key builds its runners at every warm
    bucket before it returns; the batches after it build nothing."""
    params, plan = _variant("ecr-pecr")
    pruned, pplan = _variant("pruned")
    eng = _engine(params, plan=plan)
    eng.warmup()
    builds = eng.cache.compiles
    assert eng.hot_swap(pruned, plan=pplan) is True
    assert eng.cache.compiles == builds + 2
    for n in (1, 3, 4):
        out = eng.serve(list(_batch(n, seed=7 * n)))
        assert out.shape == (n, GRAPH.n_classes())
    assert eng.cache.compiles == builds + 2
    stats = eng.stats()
    assert stats["batch_builds"] == 0
    assert stats["captures"] == 0 and stats["graph_pool_bytes"] == 0  # host: no graphs
    cold = _engine(params, plan=plan)  # no warmup: a bucket's first batch builds
    cold.serve(list(_batch(3, seed=5)))
    assert cold.stats()["batch_builds"] == 1
