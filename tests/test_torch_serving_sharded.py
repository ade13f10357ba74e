"""Data-parallel serving on the port, on the host: `run_plan_sharded` and
`Engine(mesh=)` over N CPU slots (`data_mesh(n, devices=[cpu] * n)`, the
counterpart of the reference's virtual CPU devices) against whole-batch
`run_plan`, the occupancy statistic aggregated over the shards, the
logical-axis rules against the JAX package's, `auto_mesh`, the plan cache's
mesh shape, `autotune(mesh=)` and `serve_cnn --devices`.

The reference test's tiny CNN (`tests/test_serving_sharded.py`) with a
shared dead-channel band over every sample, drawn with numpy: under that
union condition the compaction is batch-composition-invariant, and the
host's convolutions are batch-invariant, so sharded logits are bitwise
equal to the whole batch's. The occupancy statistic is held at rtol 1e-6
(its sums run in another order over the shards); the port against the JAX
package at the CNN parity rule, rtol 1e-4 and atol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.vgg19_sparse import CNNConfig as J_CNNConfig  # noqa: E402
from repro.configs.vgg19_sparse import vgg19_graph as j_vgg19_graph  # noqa: E402
from repro.graph import init_graph as j_init_graph  # noqa: E402
from repro.parallel.api import DEFAULT_RULES as J_RULES  # noqa: E402
from repro.parallel.api import axes_leaves as j_axes_leaves  # noqa: E402
from repro.parallel.api import axis_rules as j_axis_rules  # noqa: E402
from repro.parallel.api import logical_spec as j_logical_spec  # noqa: E402
from repro.pipeline import plan_network as j_plan_network  # noqa: E402
from repro.pipeline import run_plan as j_run_plan  # noqa: E402
from repro_torch.configs.vgg19_sparse import CNNConfig, vgg19_graph  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.serve_cnn import serve_cnn  # noqa: E402
from repro_torch.parallel import (  # noqa: E402
    DEFAULT_RULES,
    Mesh,
    axes_leaves,
    axis_rules,
    current_mesh,
    data_mesh,
    local_devices,
    logical_spec,
)
from repro_torch.pipeline import plan_network, run_plan, run_plan_sharded  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    Engine,
    SimClock,
    auto_mesh,
    autotune,
    plan_key,
)
from repro_torch.serving.graph_runner import ShardedRunner  # noqa: E402

CPU = torch.device("cpu")
TINY = dict(name="vgg-serve-tiny", in_channels=16, img_size=12, plan=((8, 1), (16, 1)),
            n_classes=4)
GRAPH = vgg19_graph(CNNConfig(**TINY))


def cpu_mesh(n: int) -> Mesh:
    return data_mesh(n, devices=[CPU] * n)


def img(seed: int, dead: int = 8) -> np.ndarray:
    """(16, 12, 12) uniform [0, 1) from numpy's generator `seed`, with the
    trailing `dead` channels zero (the shared dead band)."""
    x = np.random.default_rng(seed).random((16, 12, 12), dtype=np.float32)
    if dead:
        x[16 - dead:] = 0.0
    return x


@pytest.fixture(scope="module")
def tiny():
    """(JAX params, port params, port plan, JAX plan): the JAX package's
    own draw carried across, each package planned on the same two images."""
    jg = j_vgg19_graph(J_CNNConfig(**TINY))
    jp = j_init_graph(jax.random.PRNGKey(0), jg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    calib = np.stack([img(900), img(901)])
    plan = plan_network(tp, torch.from_numpy(calib), GRAPH, occ_threshold=0.9, block_c=8)
    jplan = j_plan_network(jp, jnp.asarray(calib), jg, occ_threshold=0.9, block_c=8)
    assert any(lp.impl != "dense" for lp in plan.layers)  # a sparse kernel in play
    return jp, tp, plan, jplan


def batch(kind: str):
    """(images, n_valid): 8 real images, or 6 real and 2 all-zero pads."""
    full = torch.from_numpy(np.stack([img(i) for i in range(8)]))
    if kind == "full":
        return full, None
    return torch.cat([full[:6], torch.zeros_like(full[:2])]), 6


# ---- the logical-axis rules against the JAX package's ---------------------

MESHES = {"data8": ((8,), ("data",)), "data1": ((1,), ("data",)),
          "data2_model4": ((2, 4), ("data", "model")),
          "pod_data_model": ((2, 2, 2), ("pod", "data", "model")),
          "model4": ((4,), ("model",))}
SPEC_CASES = [((8, 16, 4), ("batch", None, "heads")), ((1, 16), ("batch", "cache_seq")),
              ((6, 7), ("embed", "heads")), ((4, 4), ("heads", "mlp")),
              ((12, 8, 6), ("expert_cap", "experts", "mlp")), ((3, 5), ("vocab", "embed"))]


def mesh_of(name: str) -> Mesh:
    shape, axes = MESHES[name]
    return Mesh(np.array([CPU] * int(np.prod(shape)), dtype=object).reshape(shape), axes)


@pytest.mark.parametrize("case", range(len(SPEC_CASES)))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_logical_spec_matches_the_reference(mesh_name, case):
    """The reference's `logical_spec`, given the port's mesh (it reads only
    `axis_names` and `shape`), against the port's, with and without fsdp."""
    mesh = mesh_of(mesh_name)
    shape, names = SPEC_CASES[case]
    for fsdp in (True, False):
        with axis_rules(mesh, fsdp=fsdp), j_axis_rules(mesh, fsdp=fsdp):
            assert logical_spec(shape, names) == tuple(j_logical_spec(shape, names))
            assert current_mesh() is mesh
    assert current_mesh() is None
    assert logical_spec(shape, names, mesh) == tuple(j_logical_spec(shape, names, mesh))


def test_logical_spec_pruning_rules_of_the_reference_test():
    """`tests/test_distributed.py::test_logical_spec_pruning_rules`' cases,
    on the port, and the rules tables equal."""
    assert DEFAULT_RULES == J_RULES
    mesh = mesh_of("pod_data_model")
    with axis_rules(mesh):
        assert logical_spec((8, 16, 4), ("batch", None, "heads"), mesh) == \
            (("pod", "data"), None, "model")
        assert logical_spec((1, 16), ("batch", "cache_seq"), mesh) == (None, ("pod", "data"))
        assert logical_spec((6, 7), ("embed", "heads"), mesh)[1] is None
        s2 = logical_spec((4, 4), ("heads", "mlp"), mesh)
        assert not (s2[0] == "model" and s2[1] == "model")
    assert logical_spec((8, 3), ("batch", None)) == ()  # no mesh: resolves nothing
    assert logical_spec((8, 3, 12, 12), ("batch", None, None, None), cpu_mesh(2)) == \
        ("data", None, None, None)
    tree = {"b": [("batch", None), None, {"z": ("heads",), "a": ()}], "a": (("embed", "mlp"),)}
    assert axes_leaves(tree) == j_axes_leaves(tree)


def test_mesh_and_data_mesh():
    mesh = cpu_mesh(3)
    assert (mesh.axis_names, mesh.shape, mesh.size, mesh.slots) == \
        (("data",), {"data": 3}, 3, [CPU] * 3)
    assert data_mesh(devices=[CPU] * 2).size == 2
    assert data_mesh().size == len(local_devices())  # the host: one CPU device
    for n in (0, 4):
        with pytest.raises(ValueError, match="exposes 3 device"):
            data_mesh(n, devices=[CPU] * 3)
    with pytest.raises(ValueError, match="cannot take the axes"):
        Mesh([CPU] * 4, ("data", "model"))
    w = torch.ones(3)
    meta = torch.device("meta")
    assert mesh.place(w, CPU) is w  # already there: the tensor itself
    first = mesh.place(w, meta)
    assert first.device == meta and mesh.place(w, meta) is first  # copied once
    w.add_(1.0)  # changed in place: placed anew
    assert mesh.place(w, meta) is not first


# ---- run_plan_sharded -------------------------------------------------------

@pytest.mark.parametrize("n_dev", [1, 2, 4])
@pytest.mark.parametrize("kind", ["full", "ragged"])
def test_run_plan_sharded_bitwise_equal_to_run_plan(tiny, kind, n_dev):
    _, tp, plan, _ = tiny
    imgs, nv = batch(kind)
    ref, ref_occs = run_plan(plan, tp, imgs, collect_occupancy=True, n_valid=nv)
    out, occs = run_plan_sharded(plan, tp, imgs, cpu_mesh(n_dev), collect_occupancy=True,
                                 n_valid=nv)
    assert torch.equal(out, ref), (out - ref).abs().max()
    np.testing.assert_allclose(occs.numpy(), ref_occs.numpy(), rtol=1e-6, atol=1e-6)
    # the logits-only path, and each shard bitwise run_plan on its own slice
    out = run_plan_sharded(plan, tp, imgs, cpu_mesh(n_dev))
    rows = 8 // n_dev
    for i in range(n_dev):
        assert torch.equal(out[i * rows:(i + 1) * rows],
                           run_plan(plan, tp, imgs[i * rows:(i + 1) * rows]))


def test_run_plan_sharded_refuses_what_it_cannot_split(tiny):
    _, tp, plan, _ = tiny
    imgs, _ = batch("full")
    with pytest.raises(ValueError, match=r"divide.*MicroBatcher\(align=4\)"):
        run_plan_sharded(plan, tp, imgs[:6], cpu_mesh(4))
    with pytest.raises(ValueError, match="'data' axis"):
        run_plan_sharded(plan, tp, imgs, Mesh([CPU] * 2, ("model",)))
    with pytest.raises(ValueError, match="'data' alone"):
        run_plan_sharded(plan, tp, imgs, Mesh(np.array([CPU] * 4, dtype=object)
                                                .reshape(2, 2), ("data", "model")))
    # a one-slot mesh, with or without a data axis, is plain run_plan
    assert torch.equal(run_plan_sharded(plan, tp, imgs, Mesh([CPU], ("model",))),
                       run_plan(plan, tp, imgs))


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_occupancy_weighs_all_pad_shards_zero(tiny, n_dev):
    """4 real images and 4 all-zero pads: at 4 slots the last two shards
    hold only pads (weight 0), at 2 the second does; the aggregate is the
    whole batch's n_valid-masked statistic."""
    _, tp, plan, _ = tiny
    full, _ = batch("full")
    imgs = torch.cat([full[:4], torch.zeros_like(full[:4])])
    _, occs = run_plan_sharded(plan, tp, imgs, cpu_mesh(n_dev), collect_occupancy=True,
                               n_valid=4)
    _, ref = run_plan(plan, tp, imgs, collect_occupancy=True, n_valid=4)
    assert torch.all(torch.isfinite(occs))
    np.testing.assert_allclose(occs.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)
    assert occs[0] < 1.0  # the dead band registered, not washed out
    # a device-side count gives the same statistic as the int
    _, occs_t = run_plan_sharded(plan, tp, imgs, cpu_mesh(n_dev), collect_occupancy=True,
                                 n_valid=torch.tensor(4, dtype=torch.int32))
    assert torch.equal(occs_t, occs)


def test_sharded_logits_match_the_jax_package(tiny):
    """The port's sharded logits and aggregated occupancy against the
    reference's whole-batch `run_plan` (its own test shows its sharded
    result bit-identical to that), on the same params and images."""
    jp, tp, plan, jplan = tiny
    assert [(lp.kind, lp.impl) for lp in plan.layers] == \
        [(lp.kind, lp.impl) for lp in jplan.layers]
    imgs, nv = batch("ragged")
    want, want_occs = j_run_plan(jplan, jp, jnp.asarray(imgs.numpy()),
                                 collect_occupancy=True, n_valid=nv)
    got, occs = run_plan_sharded(plan, tp, imgs, cpu_mesh(4), collect_occupancy=True,
                                 n_valid=nv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(occs.numpy(), np.asarray(want_occs), rtol=1e-6, atol=1e-6)


# ---- auto_mesh, the engine, the cache, autotune, the launcher -----------------

@pytest.mark.parametrize("max_batch,min_bucket,want", [
    (8, 2, 2), (6, 2, 3), (1, 2, 1), (2, 2, 1), (2, 1, 2)])
def test_auto_mesh_degrades_on_awkward_slot_counts(max_batch, min_bucket, want):
    """3 slots: the largest count dividing max_batch with at least
    min_bucket samples a shard (the reference's table)."""
    assert auto_mesh(max_batch, min_bucket, devices=[CPU] * 3).size == want


def engine(tp, plan, mesh, **kw):
    return Engine(tp, graph=GRAPH, plan=plan, max_batch=8, deadline_s=0.005,
                  clock=SimClock(), mesh=mesh, device="cpu", **kw)


def test_sharded_engine_serves_the_unsharded_logits(tiny):
    _, tp, plan, _ = tiny
    imgs = [torch.from_numpy(img(i)) for i in range(6)]  # ragged: 6 -> an 8-bucket
    ref = run_plan(plan, tp, torch.stack(imgs)).numpy()
    single = engine(tp, plan, None)
    assert single.n_devices == 1 and single.stats()["devices"] == 1
    assert np.array_equal(single.serve(imgs), ref)
    sharded = engine(tp, plan, cpu_mesh(4))
    assert sharded.n_devices == 4 and sharded.batcher.exec_buckets() == (8,)
    assert np.array_equal(sharded.serve(imgs), ref)
    stats = sharded.stats()
    assert stats["devices"] == 4 and stats["pad_samples"] == 2
    assert stats["captures_per_slot"] == [0] * 4  # the host replays eagerly
    assert all(np.isfinite(v) for v in stats["occ_ema"])
    # the default mesh on the host is one slot: today's keys and runners
    auto = Engine(tp, graph=GRAPH, plan=plan, max_batch=8, clock=SimClock(), device="cpu")
    assert auto.mesh is None and auto.n_devices == 1
    # one shared cache holds the 1..N-slot layouts side by side
    keys = {plan_key(8, plan), plan_key(8, plan, cpu_mesh(2)), plan_key(8, plan, cpu_mesh(4))}
    assert len(keys) == 3
    assert plan_key(8, plan, cpu_mesh(1)) == plan_key(8, plan)
    assert plan_key(8, plan, cpu_mesh(2)).mesh_shape == (("data", 2),)
    assert plan_key(8, plan).mesh_shape == ()


def test_sharded_engine_builds_each_runner_once_and_hot_swaps(tiny):
    """Steady-state sharded serving builds nothing after warmup; a hot swap
    to a pruned variant builds its sharded runners before it lands and
    serves its plan's logits; swapping back builds nothing."""
    from repro_torch.sparse_weights.prune import prune_graph_params

    _, tp, plan, _ = tiny
    eng = engine(tp, plan, cpu_mesh(2))
    assert eng.warmup() == len(eng.batcher.exec_buckets())
    builds = eng.cache.stats()["compiles"]
    for wave in range(2):
        eng.serve([torch.from_numpy(img(100 + 10 * wave + i)) for i in range(5)])
    assert eng.cache.stats()["compiles"] == builds and eng.batch_builds == 0
    assert isinstance(eng._executable(8), ShardedRunner)
    pruned, _ = prune_graph_params(tp, 0.5, GRAPH)
    imgs = [torch.from_numpy(img(200 + i)) for i in range(4)]
    assert eng.hot_swap(pruned, calib=torch.stack(imgs[:2]))
    after = eng.cache.stats()["compiles"]
    assert np.array_equal(eng.serve(imgs), run_plan(eng.plan, pruned, torch.stack(imgs)).numpy())
    assert eng.cache.stats()["compiles"] == after and eng.batch_builds == 0
    assert eng.hot_swap(tp, plan=plan)
    assert eng.cache.stats()["compiles"] == after
    assert np.array_equal(eng.serve(imgs), run_plan(plan, tp, torch.stack(imgs)).numpy())


def test_engine_refuses_a_mesh_it_cannot_serve(tiny):
    _, tp, plan, _ = tiny
    with pytest.raises(ValueError, match="multiple of"):
        engine(tp, plan, cpu_mesh(3))
    with pytest.raises(ValueError, match="'data' axis"):
        engine(tp, plan, Mesh([CPU] * 2, ("model",)))
    with pytest.raises(ValueError, match="serves on cpu"):
        engine(tp, plan, data_mesh(2, devices=["cuda:0"] * 2))
    with pytest.raises(ValueError, match="'auto', None or a Mesh"):
        engine(tp, plan, "all")


def test_sharded_runner_takes_a_device_side_count(tiny):
    _, tp, plan, _ = tiny
    imgs, _ = batch("ragged")
    runner = ShardedRunner(plan, tp, 8, cpu_mesh(2))
    logits, occs = runner(tp, imgs, 6)
    logits_t, occs_t = runner(tp, imgs, torch.tensor(6, dtype=torch.int32))
    assert torch.equal(logits, logits_t) and torch.equal(occs, occs_t)
    assert not runner.bind(tp)  # the slots hold these params already
    with pytest.raises(ValueError, match="takes 8 images"):
        runner(tp, imgs[:4], 4)


@pytest.mark.parametrize("mode", ["model", "time"])
def test_autotune_over_a_mesh(tiny, mode):
    """mode="model" picks what mesh=None picks; mode="time" times each
    candidate through the sharded runner."""
    _, tp, _, _ = tiny
    calib = torch.from_numpy(np.stack([img(900), img(901)]))
    kw = dict(thresholds=(0.0, 0.9), block_cs=(8,), iters=1, mode=mode)
    res = autotune(tp, calib, GRAPH, mesh=cpu_mesh(2), **kw)
    assert len(res.candidates) == 2 and res.plan is not None
    if mode == "model":
        ref = autotune(tp, calib, GRAPH, mesh=None, **kw)
        assert plan_key(2, res.plan) == plan_key(2, ref.plan)
        assert (res.best.occ_threshold, res.best.block_c) == \
            (ref.best.occ_threshold, ref.best.block_c)
    else:
        assert all(c.wall_us < float("inf") for c in res.candidates)


def test_serve_cnn_devices_on_the_host():
    out = serve_cnn(devices=2, device="cpu", n_requests=8, rate=400.0)
    assert out["devices"] == 2 and out["requests"] == 8
    assert serve_cnn(device="cpu", n_requests=4, rate=400.0)["devices"] == 1
