"""int8 on the port against the JAX package: absmax quantization, the int8
ECR conv and int8 BSR conv (the JAX side runs its Pallas kernels in
interpret mode, the port its plain versions), the (ids, cnt) schedules on
quantized operands, the launch builders and cost hooks, and int8 planning
with its probe on the three tiny graphs. The same numpy inputs, made from a
seed, go to both packages.

Tolerances:
- quantized int8 values and scales, schedules, launch fields, cost hooks,
  plan decisions and `Int8Report.layers` / `demoted`: identical;
- `ecr_conv_int8` and `conv2d_bsr_int8`: 1e-6 * max|ref| + 1e-7 (the
  integer sums are exact on both sides; the rescale's two fp32 products
  round alike or one ulp apart);
- run_plan logits of int8 and pruned+int8 plans: rtol 1e-4 and atol
  1e-4 * max|ref| (`test_torch_sparse_weights._close_logits`).

Plans are compared with the port's roofline constants patched to the JAX
package's, read at test time."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.bsr_matmul.ops import block_schedule as j_block_schedule  # noqa: E402
from repro.kernels.ecr_conv.ops import batch_block_schedule as j_batch_block_schedule  # noqa: E402
from repro.obs import constants as j_constants  # noqa: E402
from repro.pipeline.planner import plan_network as j_plan_network  # noqa: E402
from repro.pipeline.planner import run_plan as j_run_plan  # noqa: E402
from repro.quant import conv2d_bsr_int8 as j_conv2d_bsr_int8  # noqa: E402
from repro.quant import conv2d_bsr_int8_ref as j_conv2d_bsr_int8_ref  # noqa: E402
from repro.quant import ecr_conv_int8 as j_ecr_conv_int8  # noqa: E402
from repro.quant import ecr_conv_int8_ref as j_ecr_conv_int8_ref  # noqa: E402
from repro.quant.ops import bsr_conv_int8_cost as j_bsr_conv_int8_cost  # noqa: E402
from repro.quant.ops import bsr_conv_int8_launch as j_bsr_conv_int8_launch  # noqa: E402
from repro.quant.ops import ecr_conv_int8_cost as j_ecr_conv_int8_cost  # noqa: E402
from repro.quant.ops import ecr_conv_int8_launch as j_ecr_conv_int8_launch  # noqa: E402
from repro.quant.quantize import absmax_scale as j_absmax_scale  # noqa: E402
from repro.quant.quantize import quantize_acts as j_quantize_acts  # noqa: E402
from repro.quant.quantize import quantize_int8 as j_quantize_int8  # noqa: E402
from repro.quant.quantize import quantize_weights as j_quantize_weights  # noqa: E402
from repro.sparse_weights import prune_graph_params as j_prune_graph_params  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.graph.registry import get_op, unit_model_us  # noqa: E402
from repro_torch.kernels.bsr_matmul.ops import block_schedule  # noqa: E402
from repro_torch.kernels.ecr_conv.ops import batch_block_schedule  # noqa: E402
from repro_torch.kernels.tiles import CUDA_CONV_FIELDS  # noqa: E402
from repro_torch.obs import constants  # noqa: E402
from repro_torch.pipeline import plan_network, run_plan  # noqa: E402
from repro_torch.quant.ops import (  # noqa: E402
    bsr_conv_int8_cost,
    bsr_conv_int8_launch,
    conv2d_bsr_int8,
    conv2d_bsr_int8_ref,
    ecr_conv_int8,
    ecr_conv_int8_cost,
    ecr_conv_int8_launch,
    ecr_conv_int8_ref,
)
from repro_torch.quant.quantize import (  # noqa: E402
    absmax_scale,
    dequantize_int8,
    quantize_acts,
    quantize_int8,
    quantize_weights,
)
from repro_torch.sparse_weights.conv import conv2d_bsr_ref  # noqa: E402
from repro_torch.sparse_weights.format import conv_weight_matrix  # noqa: E402
from test_torch_planner import GRAPHS  # noqa: E402
from test_torch_sparse_weights import _close_logits, _setup  # noqa: E402


@pytest.fixture
def reference_roofline(monkeypatch):
    monkeypatch.setattr(constants, "DEFAULT_ROOFLINE", constants.RooflineConstants(
        j_constants.DEFAULT_PEAK_FLOPS, j_constants.DEFAULT_HBM_BW))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _fm(shape, sparsity, seed=0):
    """A feature map whose channels are dead with probability `sparsity`."""
    rng = np.random.default_rng(seed)
    x = rng.random(shape, dtype=np.float32)
    lead = shape[:-2] + (1, 1)
    return x * (rng.random(lead) >= sparsity).astype(np.float32)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-6 * np.abs(want).max() + 1e-7)


# ---------------------------------------------------------------------------
# quantization primitives
# ---------------------------------------------------------------------------


def test_absmax_roundtrip_bound():
    x = _t(np.random.default_rng(0).standard_normal(64) * 3.0)
    s = absmax_scale(x)
    xq = quantize_int8(x, s)
    assert xq.dtype == torch.int8
    err = (dequantize_int8(xq, s) - x).abs()
    assert float(err.max()) <= float(s) / 2 + 1e-7
    assert int(xq.abs().max()) == 127


def test_zero_maps_to_zero_exactly():
    x = torch.zeros(4, 6, 6)
    x[0] = 1.0
    xq = quantize_int8(x, absmax_scale(x))
    assert int(xq[1:].abs().sum()) == 0


def test_round_half_to_even_as_the_reference():
    """x / scale lands exactly on .5 steps: both packages round to even."""
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0, 126.5], np.float32)
    got = quantize_int8(_t(x), torch.tensor(1.0))
    want = np.asarray(j_quantize_int8(jnp.asarray(x), 1.0))
    assert np.array_equal(got.numpy(), want)
    assert got.tolist() == [0, 2, 2, 0, -2, 127, 126]


@pytest.mark.parametrize("seed", [0, 1])
def test_quantizers_match_reference(seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((6, 4, 3, 3)).astype(np.float32)
    w[3] *= 100.0  # one huge channel must not crush the others
    w[5] = 0.0  # an all-zero channel divides by the floored scale
    wq, sw = quantize_weights(_t(w))
    jwq, jsw = j_quantize_weights(jnp.asarray(w))
    assert np.array_equal(wq.numpy(), np.asarray(jwq))
    assert np.array_equal(sw.numpy(), np.asarray(jsw))
    x = _fm((3, 8, 5, 5), 0.5, seed)
    for per_sample in (False, True):
        xq, sx = quantize_acts(_t(x), per_sample=per_sample)
        jxq, jsx = j_quantize_acts(jnp.asarray(x), per_sample=per_sample)
        assert np.array_equal(xq.numpy(), np.asarray(jxq))
        assert np.array_equal(sx.numpy(), np.asarray(jsx))
    assert np.array_equal(absmax_scale(_t(x), axis=(1, 2, 3)).numpy(),
                          np.asarray(j_absmax_scale(jnp.asarray(x), axis=(1, 2, 3))))
    for i in range(6):
        np.testing.assert_allclose(dequantize_int8(wq[i], sw[i]).numpy(), w[i],
                                   atol=float(sw[i]) / 2 + 1e-7)


# ---------------------------------------------------------------------------
# int8 ECR conv against the JAX package's Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sparsity", [0.0, 0.5, 1.0])
def test_ecr_int8_single_matches_reference(sparsity):
    x = _fm((16, 12, 12), sparsity)
    k = np.random.default_rng(2).standard_normal((24, 16, 3, 3)).astype(np.float32)
    want = j_ecr_conv_int8(jnp.asarray(x), jnp.asarray(k), block_c=8)
    _close(ecr_conv_int8(_t(x), _t(k), block_c=8).numpy(), want)
    _close(ecr_conv_int8_ref(_t(x), _t(k)).numpy(),
           j_ecr_conv_int8_ref(jnp.asarray(x), jnp.asarray(k)))


@pytest.mark.parametrize("c,o,hw,k,stride", [
    (16, 24, 12, 3, 1), (3, 16, 15, 11, 4), (6, 16, 14, 5, 1), (20, 70, 15, 3, 2),
])
def test_ecr_int8_batched_matches_reference(c, o, hw, k, stride):
    x = np.stack([_fm((c, hw, hw), 0.5, seed=s) for s in range(3)])
    x[-1] = 0.0  # an all-zero pad sample: cnt = 0
    w = np.random.default_rng(c + o).standard_normal((o, c, k, k)).astype(np.float32)
    want = j_ecr_conv_int8(jnp.asarray(x), jnp.asarray(w), stride=stride, block_c=8)
    got = ecr_conv_int8(_t(x), _t(w), stride=stride, block_c=8)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got.numpy(), want)
    assert float(got[-1].abs().max()) == 0.0
    _close(ecr_conv_int8_ref(_t(x), _t(w), stride).numpy(),
           j_ecr_conv_int8_ref(jnp.asarray(x), jnp.asarray(w), stride))


def test_ecr_int8_schedule_on_quantized_values_matches_reference():
    """Quantize after compaction, schedule on the int8 values: a channel
    block that rounds to zero is skipped on both sides alike."""
    x = np.stack([_fm((16, 8, 8), 0.5, seed=s) for s in range(3)])
    x[0, 8:] *= 1e-4  # a block that quantizes to all zeros
    xq, _ = quantize_acts(_t(x), per_sample=True)
    jxq, _ = j_quantize_acts(jnp.asarray(x), per_sample=True)
    ids, cnt = batch_block_schedule(xq.permute(0, 2, 3, 1).contiguous(), 8, 8, 8)
    jids, jcnt = j_batch_block_schedule(jnp.transpose(jxq, (0, 2, 3, 1)), 8, 8, 8)
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    assert np.array_equal(cnt.numpy(), np.asarray(jcnt))
    assert int(cnt[0]) == 1


def test_ecr_int8_vs_fp32_tolerance():
    from repro_torch.kernels.ecr_conv.ops import ecr_conv

    x = _t(_fm((16, 12, 12), 0.5, seed=6))
    k = _t(np.random.default_rng(7).standard_normal((24, 16, 3, 3)))
    q, f = ecr_conv_int8(x, k), ecr_conv(x, k)
    assert float((q - f).abs().max()) <= 0.05 * float(f.abs().max())


# ---------------------------------------------------------------------------
# int8 BSR conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,c,o,hw,k,stride", [
    (2, 16, 24, 12, 3, 1), (1, 3, 64, 10, 3, 1), (2, 3, 8, 15, 11, 4),
    (2, 6, 6, 14, 5, 2),
])
def test_bsr_int8_matches_reference(n, c, o, hw, k, stride):
    from repro.sparse_weights import prune_matrix as j_prune_matrix
    from repro.sparse_weights import weight_block as j_weight_block

    rng = np.random.default_rng(o + hw)
    w = rng.standard_normal((o, c, k, k)).astype(np.float32)
    mat = w.reshape(o, -1)
    w = np.asarray(j_prune_matrix(mat, 0.3, j_weight_block(*mat.shape))[0]).reshape(w.shape)
    x = np.stack([_fm((c, hw, hw), 0.3, seed=s) for s in range(n)])
    want = j_conv2d_bsr_int8(jnp.asarray(x), jnp.asarray(w), stride=stride)
    got = conv2d_bsr_int8(_t(x), _t(w), stride=stride)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got.numpy(), want)
    # a single image has its own patch scale, so it is held against the
    # reference's single-image path, not against its row of the batch
    _close(conv2d_bsr_int8(_t(x[0]), _t(w), stride=stride).numpy(),
           j_conv2d_bsr_int8(jnp.asarray(x[0]), jnp.asarray(w), stride=stride))
    _close(conv2d_bsr_int8_ref(_t(x), _t(w), stride).numpy(),
           j_conv2d_bsr_int8_ref(jnp.asarray(x), jnp.asarray(w), stride))
    f = conv2d_bsr_ref(_t(x), _t(w), stride)
    assert float((got - f).abs().max()) <= 0.05 * float(f.abs().max())
    # the schedule runs over the quantized weight blocks, as in the reference
    wm = conv_weight_matrix(_t(w))
    wq = quantize_int8(wm, absmax_scale(wm, axis=1)[:, None])
    launch = bsr_conv_int8_launch(o, wm.shape[1], 1)
    bt, bf = launch.bt, launch.bf
    ids, cnt = block_schedule(wq, bt, bf)
    jwq = np.pad(wq.numpy(), ((0, (-o) % bt), (0, (-wm.shape[1]) % bf)))
    jids, jcnt = j_block_schedule(jnp.asarray(jwq), bt, bf)
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    assert np.array_equal(cnt.numpy(), np.asarray(jcnt))


# ---------------------------------------------------------------------------
# the int8 kernels' plain versions against the Pallas kernels, at the tails
# the tensor-core kernels gather over
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cnts,o", [
    ((1, 2, 3, 8, 0, 5), 16),  # cnt % 4 of 1, 2, 3 at block_c 8; cnt = n_cb; cnt = 0
    ((7, 6, 4), 24),
])
def test_ecr_int8_plain_matches_pallas_at_schedule_tails(cnts, o):
    from repro.quant.kernels import ecr_conv_int8_pallas_batch
    from repro_torch.quant.kernels import ecr_conv_int8_plain

    rng = np.random.default_rng(sum(cnts) + o)
    n, n_cb, bc = len(cnts), 8, 8
    x = rng.integers(-127, 128, (n, 7, 6, n_cb * bc)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, n_cb * bc, o)).astype(np.int8)
    sx = (rng.random((n, 1)) * 1e-2 + 1e-4).astype(np.float32)
    sw = (rng.random((1, o)) * 1e-2 + 1e-4).astype(np.float32)
    ids = np.stack([rng.permutation(n_cb) for _ in cnts]).astype(np.int32)
    cnt = np.asarray(cnts, np.int32)
    want = ecr_conv_int8_pallas_batch(*map(jnp.asarray, (x, w, sx, sw, ids, cnt)),
                                      stride=1, block_c=bc, block_o=o, interpret=True)
    got = ecr_conv_int8_plain(*map(torch.from_numpy, (x, w, sx, sw, ids, cnt)),
                              stride=1, block_c=bc)
    _close(got.numpy(), want)
    assert float(np.abs(np.asarray(want)).max()) > 0.0
    if 0 in cnts:
        assert float(got[cnts.index(0)].abs().max()) == 0.0


@pytest.mark.parametrize("t,f,d,bf", [(16, 27, 48, 8), (24, 25, 40, 8), (16, 27, 24, 16)])
def test_bsr_int8_plain_matches_pallas_at_ragged_blocks(t, f, d, bf):
    """bf = 8 (and 16) with F = 27 or 25: the ragged last block; the Pallas
    kernel takes h and w zero-padded to block multiples, the plain version
    the unpadded operands."""
    from repro.quant.kernels import bsr_matmul_int8_pallas
    from repro_torch.quant.kernels import bsr_matmul_int8_plain

    rng = np.random.default_rng(t + f + bf)
    nt, nf = -(-t // 8), -(-f // bf)
    keep = rng.random((nt, nf)) < 0.5
    keep[0] = False  # an all-pruned row-block: cnt = 0
    mask = np.repeat(np.repeat(keep, 8, 0), bf, 1)[:t, :f]
    h = rng.integers(-127, 128, (t, f)).astype(np.int8) * mask.astype(np.int8)
    w = rng.integers(-127, 128, (f, d)).astype(np.int8)
    sh = (rng.random((t, 1)) * 1e-2 + 1e-4).astype(np.float32)
    sw = np.asarray([[3.7e-3]], np.float32)
    ids, cnt = block_schedule(torch.from_numpy(h), 8, bf)
    hp = np.pad(h, ((0, 0), (0, nf * bf - f)))
    wp = np.pad(w, ((0, nf * bf - f), (0, 0)))
    want = bsr_matmul_int8_pallas(*map(jnp.asarray, (hp, wp, sh, sw, ids.numpy(),
                                                     cnt.numpy())),
                                  block=(8, bf, d), interpret=True)
    got = bsr_matmul_int8_plain(torch.from_numpy(h), torch.from_numpy(w),
                                torch.from_numpy(sh), torch.from_numpy(sw), ids, cnt,
                                block=(8, bf))
    _close(got.numpy(), want)
    assert float(got[:8].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# registry, launch builders and cost hooks
# ---------------------------------------------------------------------------


def test_int8_impls_registered_quantized():
    assert get_op("conv", "ecr_int8").quantized and get_op("conv", "ecr_int8").sparse
    assert get_op("conv", "bsr_int8").quantized and get_op("conv", "bsr_int8").weight_sparse
    assert not get_op("conv", "ecr_pallas").quantized
    assert get_op("conv", "ecr_int8").fused_with is None


@pytest.mark.parametrize("c,h,o,k,stride", [(64, 226, 64, 3, 1), (3, 227, 64, 11, 4),
                                            (512, 16, 512, 3, 1), (20, 9, 70, 3, 2)])
def test_int8_launch_builders_match_reference(c, h, o, k, stride):
    for block_c in (0, 8):
        got = ecr_conv_int8_launch(c, h, h, o, k, k, stride=stride, block_c=block_c, batch=8)
        want = j_ecr_conv_int8_launch(c, h, h, o, k, k, stride=stride, block_c=block_c, batch=8)
        # the CUDA tile and grid have no reference counterpart; every other
        # field must equal the reference's
        assert set(vars(got)) - set(vars(want)) == set(CUDA_CONV_FIELDS)
        got_f = {f: v for f, v in vars(got).items() if f not in CUDA_CONV_FIELDS}
        assert got_f == {f: getattr(want, f) for f in got_f}
    p = 8 * ((h - k) // stride + 1) ** 2
    got, want = bsr_conv_int8_launch(o, c * k * k, p), j_bsr_conv_int8_launch(o, c * k * k, p)
    assert vars(got) == {f: getattr(want, f) for f in vars(got)}


@pytest.mark.parametrize("occ,wd", [(1.0, 1.0), (0.5, 0.3), (0.1, 0.05)])
def test_int8_cost_hooks_match_reference(occ, wd):
    for args in [(64, 226, 226, 64, 3, 3), (512, 16, 16, 512, 3, 3)]:
        assert ecr_conv_int8_cost(*args, occupancy=occ, batch=8) == \
            j_ecr_conv_int8_cost(*args, occupancy=occ, batch=8)
        assert bsr_conv_int8_cost(*args, weight_density=wd, batch=8) == \
            j_bsr_conv_int8_cost(*args, weight_density=wd, batch=8)


def test_int8_cost_hooks_price_below_fp32():
    from repro_torch.launch.serve_cnn import serving_graph

    u = serving_graph("vgg19").units()[0]
    for fp, q in [(("conv", "ecr_pallas"), ("conv", "ecr_int8")),
                  (("conv", "bsr"), ("conv", "bsr_int8"))]:
        kw = dict(occupancy=0.5, weight_density=0.5, batch=2)
        assert unit_model_us(*q, u, **kw) < unit_model_us(*fp, u, **kw)


# ---------------------------------------------------------------------------
# int8 planning and its probe on the three tiny graphs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("density", [0.3, 1.0])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_int8_plan_matches_reference(name, density, reference_roofline):
    """int8 on; the same cases with int8 off are
    `test_torch_sparse_weights.py::test_pruned_plan_matches_reference`."""
    jg, tg, jp, _, calib = _setup(name)
    if density < 1.0:
        jp, _ = j_prune_graph_params(jp, density, jg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    jplan = j_plan_network(jp, jnp.asarray(calib), jg, block_c=8, int8=True)
    plan = plan_network(tp, torch.from_numpy(calib), tg, block_c=8, int8=True)
    assert [(lp.kind, lp.impl) for lp in plan.layers] == \
        [(lp.kind, lp.impl) for lp in jplan.layers]
    for a, b in zip(plan.layers, jplan.layers):
        assert a.occupancy == pytest.approx(b.occupancy, abs=1e-6)
    assert plan.counts() == jplan.counts()
    rep, jrep = plan.int8_report, jplan.int8_report
    assert (rep.layers, rep.demoted) == (jrep.layers, jrep.demoted)
    assert rep.top1_agreement == jrep.top1_agreement
    assert rep.max_logit_drift == pytest.approx(jrep.max_logit_drift, rel=1e-3, abs=1e-6)
    assert plan.counts()["int8"] == len(rep.layers)
    want = np.asarray(j_run_plan(jplan, jp, jnp.asarray(calib)))
    got = run_plan(plan, tp, torch.from_numpy(calib)).numpy()
    _close_logits(got, want)


def test_int8_plans_reach_both_int8_impls(reference_roofline):
    """Across the parity cases above, the int8 arm really upgrades layers:
    ECR layers to ecr_int8 on the unpruned VGG-tiny, BSR layers to bsr_int8
    on the pruned one."""
    jg, tg, jp, tp, calib = _setup("vgg-tiny")
    plan = plan_network(tp, torch.from_numpy(calib), tg, block_c=8, int8=True)
    assert "ecr_int8" in [lp.impl for lp in plan.layers]
    jpp, _ = j_prune_graph_params(jp, 0.3, jg)
    tpp = params_from_jax(jax.tree_util.tree_map(np.asarray, jpp), device="cpu")
    pq = plan_network(tpp, torch.from_numpy(calib), tg, block_c=8, int8=True)
    assert "bsr_int8" in [lp.impl for lp in pq.layers]
    c = pq.counts()
    assert c["int8"] >= 1 and c["bsr"] >= c["int8"]


def test_int8_plan_demotes_everything_to_meet_an_unreachable_budget():
    _, tg, _, tp, calib = _setup("vgg-tiny")
    calib = torch.from_numpy(calib)
    p = plan_network(tp, calib, tg, block_c=8, int8=True, int8_budget=1.1)
    rep = p.int8_report
    assert rep.layers == () and len(rep.demoted) >= 1
    assert all(not get_op(lp.kind, lp.impl).quantized for lp in p.layers)
    base = plan_network(tp, calib, tg, block_c=8)
    assert torch.equal(run_plan(p, tp, calib), run_plan(base, tp, calib))
