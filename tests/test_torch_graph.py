"""Parity of the port's LayerGraph IR and executor with the JAX package:
identical structure and weight shapes, identical pool shape rules (valid /
floor / ceil with the ceil clamp), and dense-path logits of VGG-tiny,
LeNet-tiny and AlexNet-tiny within rtol=1e-4, atol=1e-5 — the depth of fp32
accumulation in another summation order (XLA vs PyTorch's CPU conv)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.alexnet import ALEXNET_REDUCED as J_ALEX  # noqa: E402
from repro.configs.lenet import LENET_REDUCED as J_LENET  # noqa: E402
from repro.graph.executor import maxpool2d as j_maxpool2d  # noqa: E402
from repro.graph.executor import run_graph as j_run_graph  # noqa: E402
from repro.graph.ir import PoolSpec as JPool  # noqa: E402
from repro.graph.ir import weight_shapes as j_weight_shapes  # noqa: E402
from repro.launch.serve_cnn import serving_graph as j_serving_graph  # noqa: E402
from repro_torch.configs.alexnet import ALEXNET, ALEXNET_REDUCED  # noqa: E402
from repro_torch.configs.lenet import LENET, LENET_REDUCED  # noqa: E402
from repro_torch.configs.vgg19_sparse import CNNConfig, vgg19_graph  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.graph import init_graph, maxpool2d, run_graph, weight_shapes  # noqa: E402
from repro_torch.graph.ir import PoolSpec  # noqa: E402
from repro_torch.launch.serve_cnn import serving_graph  # noqa: E402

GRAPHS = {
    "vgg-tiny": (lambda: j_serving_graph("vgg19"), lambda: serving_graph("vgg19")),
    "lenet-tiny": (lambda: J_LENET, lambda: LENET_REDUCED),
    "alexnet-tiny": (lambda: J_ALEX, lambda: ALEXNET_REDUCED),
}


def _np_params(graph, seed=0):
    """Fan-in-scaled numpy weights in the graph-native layout."""
    rng = np.random.default_rng(seed)
    conv_shapes, dense_shapes = j_weight_shapes(graph)
    return {"conv": [rng.standard_normal(s).astype(np.float32) / np.sqrt(np.prod(s[1:]))
                     for s in conv_shapes],
            "dense": [rng.standard_normal(s).astype(np.float32) / np.sqrt(s[0])
                      for s in dense_shapes]}


def _imgs(shape, n=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n,) + tuple(shape), dtype=np.float32)
    x[:, shape[0] - shape[0] // 2:] = 0.0  # shared dead-channel band
    return x


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_structure_matches(name):
    jg, tg = (f() for f in GRAPHS[name])
    assert tg.signature() == jg.signature()
    assert [(u.in_shape, u.out_shape, u.stage, u.slot) for u in tg.units()] == \
        [(u.in_shape, u.out_shape, u.stage, u.slot) for u in jg.units()]
    assert weight_shapes(tg) == j_weight_shapes(jg)


def test_full_graphs_match_reference_shapes():
    from repro.configs.alexnet import ALEXNET as JA
    from repro.configs.lenet import LENET as JL
    from repro.configs.vgg19_sparse import CNNConfig as JCfg
    from repro.configs.vgg19_sparse import vgg19_graph as j_vgg

    for tg, jg in ((vgg19_graph(CNNConfig()), j_vgg(JCfg())), (LENET, JL), (ALEXNET, JA)):
        assert tg.signature() == jg.signature()
        assert weight_shapes(tg) == j_weight_shapes(jg)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_run_graph_dense_matches_jax(name):
    jg, tg = (f() for f in GRAPHS[name])
    params = _np_params(jg)
    x = _imgs(jg.in_shape)
    want = np.asarray(j_run_graph(jg, jax.tree_util.tree_map(jnp.asarray, params),
                                  jnp.asarray(x), "dense"))
    tp = params_from_jax(params, device="cpu")
    got = run_graph(tg, tp, torch.from_numpy(x), "dense").numpy()
    assert got.shape == want.shape == (3, tg.n_classes())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("p,s,mode,n", [
    (3, 2, "ceil", 8), (3, 2, "ceil", 7), (3, 2, "ceil", 4), (2, 2, "valid", 8),
    (3, 2, "floor", 8), (2, 3, "ceil", 7), (3, 3, "ceil", 7),
])
def test_maxpool2d_modes_match_jax(p, s, mode, n):
    """valid / floor / ceil, including AlexNet-tiny's 3x2/2 ceil pools on
    maps they do not tile (the last window must start inside the input)."""
    x = np.random.default_rng(n).standard_normal((2, 3, n, n)).astype(np.float32)
    want = np.asarray(j_maxpool2d(jnp.asarray(x), JPool(p, stride=s, mode=mode)))
    got = maxpool2d(torch.from_numpy(x), PoolSpec(p, stride=s, mode=mode)).numpy()
    np.testing.assert_array_equal(got, want)


def test_maxpool2d_valid_mode_raises_on_a_tail():
    with pytest.raises(ValueError, match="tail"):
        maxpool2d(torch.zeros(1, 7, 7), PoolSpec(2))


def test_init_graph_is_seeded_and_fan_in_scaled():
    g = LENET_REDUCED
    a = init_graph(torch.Generator().manual_seed(3), g, device="cpu")
    b = init_graph(torch.Generator().manual_seed(3), g, device="cpu")
    conv_shapes, dense_shapes = weight_shapes(g)
    assert [tuple(w.shape) for w in a["conv"]] == list(conv_shapes)
    assert [tuple(w.shape) for w in a["dense"]] == list(dense_shapes)
    for wa, wb in zip(a["conv"] + a["dense"], b["conv"] + b["dense"]):
        assert torch.equal(wa, wb) and wa.dtype == torch.float32
