"""Whole-slice parity: the port's planner against the JAX package's on the
three tiny graphs, with the JAX package's own params (init_graph +
shift_dead_channels on PRNGKey(0)) and calibration images
(synth_requests(g, 2, seed=1)) carried across as numpy arrays.

Per-layer (kind, impl) decisions must be IDENTICAL and occupancies equal to
1e-6; run_plan logits must match at rtol=1e-4, atol=1e-5 (the depth of fp32
accumulation; the sparse layers run the kernels' plain versions here and the
Pallas kernels in interpret mode there)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.alexnet import ALEXNET_REDUCED as J_ALEX  # noqa: E402
from repro.configs.lenet import LENET_REDUCED as J_LENET  # noqa: E402
from repro.graph import init_graph as j_init_graph  # noqa: E402
from repro.launch.serve_cnn import serving_graph as j_serving_graph  # noqa: E402
from repro.launch.serve_cnn import synth_requests as j_synth  # noqa: E402
from repro.models.cnn import shift_dead_channels as j_shift  # noqa: E402
from repro.pipeline.planner import plan_network as j_plan_network  # noqa: E402
from repro.pipeline.planner import run_plan as j_run_plan  # noqa: E402
from repro_torch.configs.alexnet import ALEXNET_REDUCED  # noqa: E402
from repro_torch.configs.lenet import LENET_REDUCED  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.serve_cnn import serving_graph  # noqa: E402
from repro_torch.pipeline import plan_network, run_plan, validate_plan  # noqa: E402

GRAPHS = {
    "vgg-tiny": (lambda: j_serving_graph("vgg19"), lambda: serving_graph("vgg19")),
    "lenet-tiny": (lambda: J_LENET, lambda: LENET_REDUCED),
    "alexnet-tiny": (lambda: J_ALEX, lambda: ALEXNET_REDUCED),
}

# the JAX package's plans today for these params/calib at block_c=8
EXPECTED = {
    ("vgg-tiny", 0.75): ["ecr_pallas", "dense", "dense"],
    ("vgg-tiny", 1.0): ["ecr_pallas", "pecr_pallas", "pecr_pallas"],
    ("lenet-tiny", 0.75): ["dense", "dense"],
    ("lenet-tiny", 1.0): ["pecr_pallas", "pecr_pallas"],
    ("alexnet-tiny", 0.75): ["dense"] * 5,
    ("alexnet-tiny", 1.0): ["ecr_pallas"] * 5,
}

_CACHE: dict = {}


def _setup(name):
    """(jax graph, torch graph, jax params, torch params, calib numpy) —
    built once per graph (the JAX init dominates this file's time)."""
    if name not in _CACHE:
        jg, tg = (f() for f in GRAPHS[name])
        jp = j_shift(j_init_graph(jax.random.PRNGKey(0), jg))
        calib = np.stack([np.asarray(x) for x in j_synth(jg, 2, seed=1)])
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        _CACHE[name] = (jg, tg, jp, tp, calib)
    return _CACHE[name]


@pytest.mark.parametrize("occ_threshold", [0.75, 1.0])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_plan_network_matches_jax(name, occ_threshold):
    jg, tg, jp, tp, calib = _setup(name)
    jplan = j_plan_network(jp, jnp.asarray(calib), jg, occ_threshold=occ_threshold,
                           block_c=8)
    plan = plan_network(tp, torch.from_numpy(calib), tg, occ_threshold=occ_threshold,
                        block_c=8)
    assert [(lp.kind, lp.impl) for lp in plan.layers] == \
        [(lp.kind, lp.impl) for lp in jplan.layers]
    assert [lp.impl for lp in plan.layers] == EXPECTED[(name, occ_threshold)]
    for a, b in zip(plan.layers, jplan.layers):
        assert a.occupancy == pytest.approx(b.occupancy, abs=1e-6)
        assert (a.in_shape, a.out_shape, vars(a.conv), a.relu) == \
            (b.in_shape, b.out_shape, vars(b.conv), b.relu)
        assert a.weight_density == pytest.approx(b.weight_density, abs=1e-6)

    want = np.asarray(j_run_plan(jplan, jp, jnp.asarray(calib)))
    got = run_plan(plan, tp, torch.from_numpy(calib)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_vgg_tiny_sparse_layer_occupancy_is_half():
    _, tg, _, tp, calib = _setup("vgg-tiny")
    plan = plan_network(tp, torch.from_numpy(calib), tg, occ_threshold=0.75, block_c=8)
    assert plan.layers[0].occupancy == pytest.approx(0.5)
    assert plan.counts() == {"dense": 2, "sparse": 1, "fused": 0, "bsr": 0, "int8": 0}


def test_run_plan_collects_occupancy_with_n_valid():
    _, tg, _, tp, calib = _setup("vgg-tiny")
    plan = plan_network(tp, torch.from_numpy(calib), tg, occ_threshold=1.0, block_c=8)
    imgs = torch.cat([torch.from_numpy(calib), torch.zeros((2,) + tuple(calib.shape[1:]))])
    logits, occs = run_plan(plan, tp, imgs, collect_occupancy=True, n_valid=2)
    assert occs.shape == (3,)
    assert float(occs[0]) == pytest.approx(plan.layers[0].occupancy, abs=1e-6)
    ref = run_plan(plan, tp, torch.from_numpy(calib))
    assert torch.equal(logits[:2], ref)  # pad samples never perturb real ones


def test_plan_network_refuses_pruned_weights():
    """Pruned weights are no longer refused: a layer whose block density is
    at or below `bsr_threshold` is priced on the BSR arm (which, at zero
    density, wins), and the plan runs to the dense logits of the same
    params."""
    _, tg, _, tp, calib = _setup("lenet-tiny")
    pruned = {"conv": [w.clone() for w in tp["conv"]], "dense": tp["dense"]}
    pruned["conv"][1][:, :, :, :] = 0.0
    plan = plan_network(pruned, torch.from_numpy(calib), tg, block_c=8)
    assert plan.layers[1].weight_density == 0.0
    assert plan.layers[1].impl == "bsr"
    from repro_torch.graph.executor import run_graph

    torch.testing.assert_close(run_plan(plan, pruned, torch.from_numpy(calib)),
                               run_graph(tg, pruned, torch.from_numpy(calib)),
                               rtol=1e-5, atol=1e-6)


def test_validate_plan_rejects_mismatches():
    _, tg, _, tp, calib = _setup("lenet-tiny")
    plan = plan_network(tp, torch.from_numpy(calib), tg, block_c=8)
    with pytest.raises(ValueError, match="calibrated for input shape"):
        validate_plan(plan, tp, torch.zeros(2, 1, 12, 12))
    with pytest.raises(ValueError, match=r"\(C,H,W\) or \(N,C,H,W\)"):
        validate_plan(plan, tp, torch.zeros(16, 16))
    bad = {"conv": tp["conv"][:1], "dense": tp["dense"]}
    with pytest.raises(ValueError, match="conv weights"):
        validate_plan(plan, bad, torch.from_numpy(calib))
