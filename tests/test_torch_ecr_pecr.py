"""Parity of the paper's methods as plain oracles (`repro_torch.core.ecr`,
`core.pecr`, `core.sparsity`, `models.cnn`) with the JAX package, on the
same numpy inputs (the maps drawn by the reference's `synth_feature_map`,
the kernels by `jax.random.normal`), mirroring tests/test_ecr_pecr.py and
tests/test_batched.py.

Exact: the ECR arrays (f_data, k_data, ptr), the PECR arrays (data, index,
count), `WindowStats`, `fused_traffic_bytes`, plan decisions. Outputs of
each impl against the reference's same impl at atol=rtol=1e-5 (fp32 sums in
another order); whole-network logits at 1e-4 * max|logits|. The kernel ops
(`ecr_pallas`, `pecr_pallas`) run their plain versions here and the Pallas
kernels in interpret mode there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

from repro.configs.vgg19_sparse import CNNConfig as JCNNConfig  # noqa: E402
from repro.core import conv2d as j_conv2d  # noqa: E402
from repro.core import conv_pool as j_conv_pool  # noqa: E402
from repro.core import ecr_compress as j_ecr_compress  # noqa: E402
from repro.core import synth_feature_map as j_synth  # noqa: E402
from repro.core import window_stats as j_window_stats  # noqa: E402
from repro.core.pecr import fused_traffic_bytes as j_fused_traffic_bytes  # noqa: E402
from repro.core.pecr import pecr_compress as j_pecr_compress  # noqa: E402
from repro.graph.registry import list_ops as j_list_ops  # noqa: E402
from repro.kernels.conv_pool.ops import fused_conv_pool as j_fused_conv_pool  # noqa: E402
from repro.kernels.ecr_conv.ops import ecr_conv as j_ecr_conv  # noqa: E402
from repro.models.cnn import cnn_forward as j_cnn_forward  # noqa: E402
from repro.models.cnn import init_cnn as j_init_cnn  # noqa: E402
from repro.pipeline import plan_network as j_plan_network  # noqa: E402
from repro_torch.configs.vgg19_sparse import CNNConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import (  # noqa: E402
    conv2d,
    conv_pool,
    ecr_compress,
    ecr_spmv,
    pecr_compress,
    synth_feature_map,
    window_stats,
)
from repro_torch.core import ecr as ecr_mod  # noqa: E402
from repro_torch.core.pecr import fused_traffic_bytes, pecr_conv_pool  # noqa: E402
from repro_torch.core.sparsity import extract_windows  # noqa: E402
from repro_torch.graph.registry import get_op, list_ops  # noqa: E402
from repro_torch.kernels.conv_pool.ops import fused_conv_pool  # noqa: E402
from repro_torch.kernels.conv_pool.ref import conv_pool_ref  # noqa: E402
from repro_torch.kernels.ecr_conv.ops import ecr_conv  # noqa: E402
from repro_torch.kernels.ecr_conv.ref import ecr_conv_ref  # noqa: E402
from repro_torch.models.cnn import (  # noqa: E402
    cnn_feature_maps,
    cnn_forward,
    cnn_forward_batch,
    init_cnn,
    shift_dead_channels,
)
from repro_torch.pipeline import measure_occupancy, plan_network, run_plan  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _fm(shape, sparsity, seed=0):
    """The reference's synthetic map, as numpy (fed to both packages)."""
    return np.array(j_synth(jax.random.PRNGKey(seed), shape, sparsity))


def _k(shape, seed=1):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape))


def _both(*arrays):
    """(jax arrays, torch tensors) of the same numpy values."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


def _batch(n, shape, sparsities, seed=0):
    """A batch with per-sample (ragged) sparsity."""
    return np.stack([_fm(shape, s, seed + i) for i, s in zip(range(n), sparsities)])


# ---------------------------------------------------------------------------
# registry: the same ten (kind, impl) pairs, the oracles off the kernel flag
# ---------------------------------------------------------------------------


def test_list_ops_matches_reference():
    got = {(op.kind, op.impl) for op in list_ops()}
    assert got == {(op.kind, op.impl) for op in j_list_ops()}
    assert len(got) == 10
    for op in j_list_ops():
        mine = get_op(op.kind, op.impl)
        assert (mine.sparse, mine.weight_sparse, mine.quantized, mine.pallas,
                mine.fused_with) == (op.sparse, op.weight_sparse, op.quantized,
                                     op.pallas, op.fused_with)
        assert (mine.launch is None) == (op.launch is None)


# ---------------------------------------------------------------------------
# equivalence: every impl == the reference's, at the paper's strides
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("impl", ["ecr", "im2col"])
@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.95, 1.0])
def test_conv_equivalence(stride, impl, sparsity):
    (jx, jk), (tx, tk) = _both(_fm((4, 11, 11), sparsity), _k((3, 4, 3, 3)))
    want = j_conv2d(jx, jk, stride, impl)
    _close(conv2d(tx, tk, stride, impl), want)
    _close(conv2d(tx, tk, stride, impl), j_conv2d(jx, jk, stride, "dense"), atol=1e-4)


@pytest.mark.parametrize("sparsity", [0.0, 0.7, 1.0])
def test_conv_pool_equivalence(sparsity):
    (jx, jk), (tx, tk) = _both(_fm((4, 10, 10), sparsity), _k((3, 4, 3, 3)))
    for impl in ("unfused", "pecr"):
        _close(conv_pool(tx, tk, 1, 2, None, impl), j_conv_pool(jx, jk, 1, 2, None, impl))
    _close(conv_pool(tx, tk, 1, 2, None, "pecr"), j_conv_pool(jx, jk, 1, 2, None, "unfused"),
           atol=1e-4)


def test_pooling_stride_one_matches_paper_fig7():
    """Paper Fig. 7 uses conv stride 1 AND pooling stride 1."""
    (jx, jk), (tx, tk) = _both(_fm((1, 5, 5), 0.5), _k((1, 1, 3, 3)))
    out = conv_pool(tx, tk, 1, 2, 1, "pecr")
    assert tuple(out.shape) == (1, 2, 2)
    _close(out, j_conv_pool(jx, jk, 1, 2, 1, "pecr"))
    _close(out, j_conv_pool(jx, jk, 1, 2, 1, "unfused"), atol=1e-4)


# ---------------------------------------------------------------------------
# format invariants (Algorithm 1 / 3): the compressed arrays, exactly
# ---------------------------------------------------------------------------


def test_ecr_format_invariants():
    (jx, jk), (tx, tk) = _both(_fm((2, 7, 7), 0.8), _k((2, 3, 3)))
    ecr, want = ecr_compress(tx, tk, 3, 3, 1), j_ecr_compress(jx, jk, 3, 3, 1)
    for f in ("f_data", "k_data", "ptr"):
        np.testing.assert_array_equal(getattr(ecr, f).numpy(), np.asarray(getattr(want, f)))
    assert ecr.ptr.dtype == torch.int32 and tuple(ecr.out_shape) == tuple(want.out_shape)
    # Ptr == nonzero count, -1 sentinel for empty windows (Algorithm 1 L12-16)
    f, ptr = ecr.f_data.numpy(), ecr.ptr.numpy()
    nnz = (extract_windows(tx, 3, 3, 1).reshape(len(ptr), -1) != 0).sum(1).numpy()
    np.testing.assert_array_equal(ptr, np.where(nnz > 0, nnz, -1))
    for i, n in enumerate(nnz):
        assert (f[i, :n] != 0).all() and (f[i, n:] == 0).all()
        assert (ecr.k_data.numpy()[i, n:] == 0).all()
    _close(ecr_spmv(ecr), conv2d(tx, tk[None], 1, "dense")[0], atol=1e-5)


@pytest.mark.parametrize("p_s", [None, 1])
def test_pecr_format_matches_reference(p_s):
    (jx,), (tx,) = _both(_fm((3, 9, 9), 0.6, seed=5))
    got, want = pecr_compress(tx, 3, 3, 1, 2, p_s), j_pecr_compress(jx, 3, 3, 1, 2, p_s)
    for f in ("data", "index", "count"):  # index is not zeroed past count
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    assert tuple(got.out_shape) == tuple(want.out_shape)
    assert got.index.dtype == torch.int32 and got.count.dtype == torch.int32
    # batched compression equals the per-image compressions
    both = pecr_compress(torch.stack([tx, tx * 0]), 3, 3, 1, 2, p_s)
    np.testing.assert_array_equal(both.data[0].numpy(), got.data.numpy())
    assert int(both.count[1].sum()) == 0


def test_paper_worked_example_mac_reduction():
    """§IV-D: the window statistics are the reference's, exactly."""
    x = _fm((1, 5, 5), 0.72, seed=3)
    got, want = window_stats(torch.from_numpy(x), 3, 3, 1), j_window_stats(x, 3, 3, 1)
    assert vars(got) == vars(want)
    assert (got.mul_reduction, got.add_reduction) == (want.mul_reduction, want.add_reduction)
    assert got.dense_muls == 9 * 9
    assert got.mul_reduction > 0.4 and got.add_reduction >= got.mul_reduction


@pytest.mark.parametrize("shape,stride", [((8, 14, 14), 1), ((3, 16, 16), 2), ((16, 9, 9), 3)])
def test_window_stats_match_reference(shape, stride):
    x = _fm(shape, 0.6, seed=sum(shape))
    assert vars(window_stats(x, 3, 3, stride)) == vars(j_window_stats(x, 3, 3, stride))


# ---------------------------------------------------------------------------
# property tests: arbitrary sparsity patterns
# ---------------------------------------------------------------------------


@settings(max_examples=25, deadline=None)
@given(data=st.data(), c=st.integers(1, 3), hw=st.integers(5, 9), stride=st.integers(1, 2))
def test_hypothesis_ecr_equals_dense(data, c, hw, stride):
    mask_bits = data.draw(st.lists(st.booleans(), min_size=c * hw * hw, max_size=c * hw * hw))
    vals = np.arange(1, c * hw * hw + 1, dtype=np.float32).reshape(c, hw, hw)
    x = vals * np.array(mask_bits, np.float32).reshape(c, hw, hw)
    (jx, jk), (tx, tk) = _both(x, _k((2, c, 3, 3), seed=7))
    got = conv2d(tx, tk, stride, "ecr")
    _close(got, j_conv2d(jx, jk, stride, "ecr"), rtol=1e-5, atol=1e-4)
    _close(got, conv2d(tx, tk, stride, "dense"), rtol=1e-4, atol=1e-4)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 10_000), sparsity=st.floats(0.0, 1.0))
def test_hypothesis_pecr_index_corrected(seed, sparsity):
    """The corrected tap index `i*k_w+j`: the PECR arrays equal the
    reference's and reproduce dense conv+pool for every pattern."""
    (jx, jk), (tx, tk) = _both(_fm((2, 8, 8), sparsity, seed=seed), _k((1, 2, 3, 3), seed))
    got, want = pecr_compress(tx, 3, 3), j_pecr_compress(jx, 3, 3)
    for f in ("data", "index", "count"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    out = conv_pool(tx, tk, 1, 2, None, "pecr")
    _close(out, j_conv_pool(jx, jk, 1, 2, None, "pecr"))
    _close(out, conv_pool(tx, tk, 1, 2, None, "unfused"), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# traffic model (paper Fig. 3 / §V), and the bounded-workspace chunking
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [((64, 56, 56), 64, 3, 3), ((512, 14, 14), 512, 3, 3, 1, 2, 1),
                                  ((3, 227, 227), 96, 11, 11, 4, 3)])
def test_fused_traffic_strictly_less(args):
    t = fused_traffic_bytes(*args)
    assert t == j_fused_traffic_bytes(*args)
    assert t["fused_bytes"] < t["unfused_bytes"] and 0.0 < t["saved_frac"] < 1.0
    if args == ((64, 56, 56), 64, 3, 3):  # the reference's case
        assert t["saved_frac"] > 0.3


def test_oracles_chunk_the_output_channels(monkeypatch):
    """A workspace of a few channels' taps gives the same values as one
    chunk: the chunking is over output channels only."""
    tx = torch.from_numpy(_batch(2, (4, 10, 10), [0.3, 0.8]))
    tk = torch.from_numpy(_k((7, 4, 3, 3)))
    whole_c, whole_p = conv2d(tx, tk, 1, "ecr"), conv_pool(tx, tk, 1, 2, None, "pecr")
    monkeypatch.setattr(ecr_mod, "ORACLE_WORKSPACE_BYTES", 64 * 36 * 4 * 3)
    assert torch.equal(conv2d(tx, tk, 1, "ecr"), whole_c)
    assert torch.equal(conv_pool(tx, tk, 1, 2, None, "pecr"), whole_p)
    # the per-output-channel Algorithm 4 equals the chunked call
    pecr = pecr_compress(tx[0], 3, 3)
    torch.testing.assert_close(pecr_conv_pool(pecr, tk[3]), whole_p[0, 3], rtol=0, atol=1e-6)


def test_synth_feature_map_hits_its_sparsity():
    g = torch.Generator().manual_seed(0)
    x = synth_feature_map(g, (64, 28, 28), 0.7, device="cpu")
    assert x.min() >= 0 and abs(float((x == 0).float().mean()) - 0.7) < 0.06
    dead = (x == 0).flatten(1).all(1).float().mean()
    assert 0.2 < float(dead) < 0.5  # half the target comes from dead channels
    again = synth_feature_map(torch.Generator().manual_seed(0), (64, 28, 28), 0.7, device="cpu")
    assert torch.equal(x, again)


# ---------------------------------------------------------------------------
# batched oracles vs the reference, all strides the paper evaluates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("impl", ["ecr", "im2col"])
def test_batched_conv_equivalence(stride, impl):
    (jx, jk), (tx, tk) = _both(_batch(3, (4, 11, 11), [0.0, 0.6, 0.95]), _k((3, 4, 3, 3)))
    out = conv2d(tx, tk, stride, impl)
    assert out.shape[0] == 3
    _close(out, j_conv2d(jx, jk, stride, impl))
    per = torch.stack([conv2d(tx[i], tk, stride, impl) for i in range(3)])
    assert torch.equal(out, per)  # the batched form is the per-image form


def test_batched_conv_pool_equivalence():
    (jx, jk), (tx, tk) = _both(_batch(2, (4, 10, 10), [0.3, 0.9]), _k((3, 4, 3, 3)))
    out = conv_pool(tx, tk, 1, 2, None, "pecr")
    _close(out, j_conv_pool(jx, jk, 1, 2, None, "pecr"))
    _close(out, j_conv_pool(jx, jk, 1, 2, None, "unfused"), atol=1e-4)
    assert torch.equal(out, torch.stack([conv_pool(tx[i], tk, 1, 2, None, "pecr")
                                         for i in range(2)]))
    ecr = ecr_compress(tx, tk[0], 3, 3)
    one = ecr_compress(tx[1], tk[0], 3, 3)
    np.testing.assert_array_equal(ecr.k_data[1].numpy(), one.k_data.numpy())


# ---------------------------------------------------------------------------
# the kernel ops: ragged per-sample sparsity in one batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stride", [1, 2, 3])
def test_batched_ecr_pallas_ragged(stride):
    # sample 0: a dead channel block; sample 1: dense; sample 2: all zero
    x = np.zeros((3, 16, 10, 10), np.float32)
    x[0] = _fm((16, 10, 10), 0.5, 0)
    x[0, 4:12] = 0
    x[1] = _fm((16, 10, 10), 0.1, 1)
    (jx, jk), (tx, tk) = _both(x, _k((8, 16, 3, 3), seed=2))
    y = ecr_conv(tx, tk, stride=stride, block_c=8)
    want = j_ecr_conv(jx, jk, stride=stride, block_c=8, block_o=8)
    _close(y, want, rtol=2e-4, atol=2e-4)
    _close(y, ecr_conv_ref(tx, tk, stride), rtol=2e-4, atol=2e-4)
    assert float(y[2].abs().max()) == 0.0  # every block of the zero sample skipped


@pytest.mark.parametrize("pool", [2, 3])
def test_batched_conv_pool_pallas_ragged(pool):
    x = np.zeros((2, 16, 11, 11), np.float32)
    x[0] = _fm((16, 11, 11), 0.7, 3)
    x[0, 8:16] = 0
    x[1] = _fm((16, 11, 11), 0.2, 4)
    (jx, jk), (tx, tk) = _both(x, _k((8, 16, 3, 3), seed=5))
    y = fused_conv_pool(tx, tk, stride=1, pool=pool, block_c=8)
    _close(y, j_fused_conv_pool(jx, jk, stride=1, pool=pool, block_c=8, block_o=8),
           rtol=2e-4, atol=2e-4)
    _close(y, conv_pool_ref(tx, tk, 1, pool), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("fn_pair", ["ecr", "conv_pool"])
def test_batch_one_matches_single_image(fn_pair):
    tx = torch.from_numpy(_fm((16, 9, 9), 0.6, 6))
    tk = torch.from_numpy(_k((8, 16, 3, 3), seed=7))
    fn = ecr_conv if fn_pair == "ecr" else fused_conv_pool
    single, batched = fn(tx, tk, block_c=8), fn(tx[None], tk, block_c=8)
    assert tuple(batched.shape) == (1,) + tuple(single.shape)
    torch.testing.assert_close(batched[0], single, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# whole network: cnn_forward at every impl vs the reference's, per image too
# ---------------------------------------------------------------------------

_J_TINY = JCNNConfig(name="vgg-tiny", img_size=16, plan=((8, 2), (16, 1)), n_classes=8)
_TINY = CNNConfig(name="vgg-tiny", img_size=16, plan=((8, 2), (16, 1)), n_classes=8)
_NET: dict = {}


def _net():
    """The reference's init_cnn (legacy layout) and 3 images, both packages."""
    if not _NET:
        jp = j_init_cnn(jax.random.PRNGKey(0), _J_TINY)
        imgs = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (3, 3, 16, 16)))
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        _NET.update(jp=jp, tp=tp, imgs=imgs)
    return _NET["jp"], _NET["tp"], _NET["imgs"]


@pytest.mark.parametrize("impl", ["dense", "im2col", "ecr", "pecr", "ecr_pallas",
                                  "pecr_pallas"])
def test_cnn_forward_batch_matches_per_image(impl):
    jp, tp, imgs = _net()
    assert set(tp) == {"stages", "fc1", "fc2"}  # the legacy layout carried across
    timgs = torch.from_numpy(imgs)
    out = cnn_forward_batch(tp, timgs, impl, _TINY)
    per = torch.stack([cnn_forward(tp, timgs[i], impl, _TINY) for i in range(3)])
    torch.testing.assert_close(out, per, rtol=1e-4, atol=1e-6)
    want = np.asarray(j_cnn_forward(jp, jnp.asarray(imgs), impl, _J_TINY))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-4 * scale)


def test_init_cnn_and_feature_maps():
    tp = init_cnn(torch.Generator().manual_seed(0), _TINY, device="cpu")
    assert [tuple(w.shape) for convs in tp["stages"] for w in convs] == \
        [(8, 3, 3, 3), (8, 8, 3, 3), (16, 8, 3, 3)]
    assert tuple(tp["fc1"].shape) == (16 * 4 * 4, 512) and tuple(tp["fc2"].shape) == (512, 8)
    shifted = shift_dead_channels(tp)
    assert set(shifted) == {"stages", "fc1", "fc2"}
    imgs = torch.rand(2, 3, 16, 16, generator=torch.Generator().manual_seed(1))
    maps = cnn_feature_maps(shifted, imgs, _TINY)
    assert [tuple(m.shape) for m in maps] == [(2, 3, 16, 16), (2, 8, 16, 16), (2, 8, 8, 8)]
    assert torch.equal(maps[0], imgs) and bool((maps[2] >= 0).all())


# ---------------------------------------------------------------------------
# the planner on the tiny VGG: occupancy, decisions, use_pallas
# ---------------------------------------------------------------------------


def test_measure_occupancy_counts_dead_channels():
    x = _fm((16, 8, 8), 0.2, 8)
    x[8:16] = 0.0
    assert measure_occupancy(torch.from_numpy(x), block_c=8) == pytest.approx(0.5)
    assert measure_occupancy(torch.zeros((2, 16, 8, 8)), block_c=8) == 0.0


def test_measure_occupancy_matches_shared_union_schedule():
    """Disjoint per-sample live sets: the union pack keeps every channel."""
    x = np.zeros((2, 16, 6, 6), np.float32)
    x[0, 0::2] = 1.0
    x[1, 1::2] = 1.0
    assert measure_occupancy(torch.from_numpy(x), block_c=8) == 1.0


def _plan_pair(occ_threshold, use_pallas):
    jp, tp, imgs = _net()
    want = j_plan_network(jp, jnp.asarray(imgs[:2]), _J_TINY, occ_threshold=occ_threshold,
                          use_pallas=use_pallas)
    got = plan_network(tp, torch.from_numpy(imgs[:2]), _TINY, occ_threshold=occ_threshold,
                       use_pallas=use_pallas)
    sig = [(lp.kind, lp.impl, lp.tile) for lp in got.layers]
    assert sig == [(lp.kind, lp.impl, lp.tile) for lp in want.layers]
    for a, b in zip(got.layers, want.layers):
        assert a.occupancy == pytest.approx(b.occupancy, abs=1e-6)
    assert got.counts() == want.counts()
    return got, tp, imgs


def test_plan_dense_when_occupancy_high():
    plan, tp, imgs = _plan_pair(0.5, True)
    assert all(lp.impl == "dense" for lp in plan.layers)  # dense input, live net
    out = run_plan(plan, tp, torch.from_numpy(imgs[:2]))
    ref = cnn_forward_batch(tp, torch.from_numpy(imgs[:2]), "dense", _TINY)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_plan_sparse_layers_still_match_dense(use_pallas):
    """Threshold 1.0 admits every layer: kernels, or with use_pallas=False
    the oracles; the plan signature equals the reference's either way."""
    plan, tp, imgs = _plan_pair(1.0, use_pallas)
    fused = "pecr_pallas" if use_pallas else "pecr"
    assert plan.layers[-1].kind == "conv_pool" and plan.layers[-1].impl == fused
    assert all(get_op(lp.kind, lp.impl).pallas == use_pallas for lp in plan.layers)
    counts = plan.counts()
    assert counts["sparse"] == len(plan.layers) and counts["fused"] == 2
    out = run_plan(plan, tp, torch.from_numpy(imgs[:2]))
    ref = cnn_forward_batch(tp, torch.from_numpy(imgs[:2]), "dense", _TINY)
    torch.testing.assert_close(out, ref, rtol=1e-3, atol=1e-3)


def test_use_pallas_false_turns_the_bsr_and_int8_arms_off():
    """A layer pruned to weight density 0 goes to BSR (or its int8 sibling)
    with the kernels; with use_pallas=False it stays off both arms, as in
    the reference."""
    jp, tp, imgs = _net()
    jp = jax.tree_util.tree_map(np.array, jp)
    jp["stages"][1][0][:] = 0.0  # conv3: weight density 0, BSR's best case
    tp = params_from_jax(jp, device="cpu")
    calib = imgs[:2]
    for use_pallas in (True, False):
        got = plan_network(tp, torch.from_numpy(calib), _TINY, occ_threshold=0.0,
                           int8=True, use_pallas=use_pallas)
        want = j_plan_network(jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(calib),
                              _J_TINY, occ_threshold=0.0, int8=True, use_pallas=use_pallas)
        assert [(lp.kind, lp.impl) for lp in got.layers] == \
            [(lp.kind, lp.impl) for lp in want.layers]
        weight_arm = {lp.impl for lp in got.layers} & {"bsr", "bsr_int8", "ecr_int8"}
        assert bool(weight_arm) == use_pallas
