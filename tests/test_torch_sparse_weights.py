"""Weight sparsity on the port against the JAX package: block pruning,
the BSR geometry and schedules, conv2d_bsr (the JAX side runs its Pallas
kernel in interpret mode, the port its plain version), the cost hooks, and
pruned planning on the three tiny graphs. The same numpy inputs, made from a
seed, go to both packages; weights cross through `convert.params_from_jax`.

Tolerances:
- prune masks and values, kept/total blocks, `weight_block`,
  `resolve_bsr_tile` / `bsr_conv_launch`, (ids, cnt) schedules, cost hooks
  and plan decisions: identical;
- block norms: 1e-6 relative (fp32 sums of squares in another order; the
  prune masks they rank are identical);
- conv2d_bsr: 1e-5 * max|ref| (fp32 sums in another order);
- run_plan logits of pruned plans: rtol 1e-4 and atol 1e-4 * max|ref| (the
  depth of fp32 accumulation; pruning shrinks the logits, so the floor
  scales with them, and max|ref| must sit far above fp32 underflow).

Plans are compared with the port's roofline constants patched to the JAX
package's, read at test time, so both price the BSR arm alike."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graph.registry import unit_model_us as j_unit_model_us  # noqa: E402
from repro.kernels.bsr_matmul.ops import block_schedule as j_block_schedule  # noqa: E402
from repro.kernels.bsr_matmul.ops import schedule_occupancy as j_schedule_occupancy  # noqa: E402
from repro.kernels.bsr_matmul.ops import sparse_matmul as j_sparse_matmul  # noqa: E402
from repro.kernels.tiles import resolve_bsr_tile as j_resolve_bsr_tile  # noqa: E402
from repro.obs import constants as j_constants  # noqa: E402
from repro.pipeline.planner import plan_network as j_plan_network  # noqa: E402
from repro.pipeline.planner import run_plan as j_run_plan  # noqa: E402
from repro.sparse_weights import conv2d_bsr as j_conv2d_bsr  # noqa: E402
from repro.sparse_weights import prune_graph_params as j_prune_graph_params  # noqa: E402
from repro.sparse_weights import prune_matrix as j_prune_matrix  # noqa: E402
from repro.sparse_weights import weight_block as j_weight_block  # noqa: E402
from repro.sparse_weights.conv import bsr_conv_cost as j_bsr_conv_cost  # noqa: E402
from repro.sparse_weights.conv import bsr_conv_launch as j_bsr_conv_launch  # noqa: E402
from repro.sparse_weights.format import block_norms as j_block_norms  # noqa: E402
from repro_torch.configs.vgg19_sparse import CNNConfig, vgg19_graph  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.graph.executor import run_graph  # noqa: E402
from repro_torch.graph.registry import get_op, unit_model_us  # noqa: E402
from repro_torch.kernels.bsr_matmul.kernel import bsr_matmul  # noqa: E402
from repro_torch.kernels.bsr_matmul.ops import (  # noqa: E402
    block_schedule,
    schedule_occupancy,
    sparse_matmul,
)
from repro_torch.kernels.bsr_matmul.ref import bsr_matmul_ref, bsr_matmul_schedule_ref  # noqa: E402
from repro_torch.kernels.tiles import resolve_bsr_tile  # noqa: E402
from repro_torch.obs import constants  # noqa: E402
from repro_torch.pipeline import plan_network, run_plan  # noqa: E402
from repro_torch.sparse_weights.conv import (  # noqa: E402
    bsr_conv_cost,
    bsr_conv_launch,
    conv2d_bsr,
    conv2d_bsr_ref,
)
from repro_torch.sparse_weights.format import block_norms, weight_block, weight_block_density  # noqa: E402
from repro_torch.sparse_weights.prune import prune_graph_params, prune_matrix  # noqa: E402
from repro_torch.graph import init_graph  # noqa: E402
from repro_torch.launch.serve_cnn import synth_requests  # noqa: E402
from repro_torch.models.cnn import shift_dead_channels  # noqa: E402
from test_torch_planner import GRAPHS  # noqa: E402

_CACHE: dict = {}


def _setup(name):
    """(jax graph, torch graph, jax params, torch params, calib numpy) for a
    tiny graph: weights from `torch.Generator(0)` with the dead-filter shift
    and two calibration images from seed 1, made once as numpy arrays and
    handed to both packages (no JAX initialisation to compile)."""
    if name not in _CACHE:
        jg, tg = (f() for f in GRAPHS[name])
        tp = shift_dead_channels(init_graph(torch.Generator().manual_seed(0), tg,
                                            device="cpu"))
        npp = {k: [w.numpy() for w in ws] for k, ws in tp.items()}
        jp = {k: [jnp.asarray(w) for w in ws] for k, ws in npp.items()}
        calib = torch.stack(synth_requests(tg, 2, seed=1, device="cpu")).numpy()
        _CACHE[name] = (jg, tg, jp, params_from_jax(npp, device="cpu"), calib)
    return _CACHE[name]


@pytest.fixture
def reference_roofline(monkeypatch):
    """The port's planner priced at the JAX package's roofline constants."""
    monkeypatch.setattr(constants, "DEFAULT_ROOFLINE", constants.RooflineConstants(
        j_constants.DEFAULT_PEAK_FLOPS, j_constants.DEFAULT_HBM_BW))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close_logits(got, want):
    """run_plan logits: rtol 1e-4 and an absolute floor of 1e-4 * max|want|,
    so the check scales with the logits however far pruning shrinks them."""
    scale = float(np.abs(want).max())
    assert scale > 1e-3, f"reference logits too small to test ({scale})"  # tiny graphs: 0.009-0.76
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


# ---------------------------------------------------------------------------
# the port's own roofline defaults
# ---------------------------------------------------------------------------


def test_default_roofline_is_the_h100s():
    """H100 SXM datasheet: 67 TFLOP/s fp32 on CUDA cores, 3.35 TB/s HBM3."""
    assert constants.DEFAULT_ROOFLINE == constants.RooflineConstants(67e12, 3.35e12)
    assert constants.DEFAULT_ROOFLINE.time_us(67e12, 0.0) == pytest.approx(1e6)
    assert constants.DEFAULT_ROOFLINE.time_us(0.0, 3.35e12) == pytest.approx(1e6)


# ---------------------------------------------------------------------------
# pruning format
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("o,k_taps", [(6, 25), (64, 27), (64, 576), (512, 4608),
                                      (16, 144), (4096, 25088)])
def test_weight_block_and_bsr_tile_match_reference(o, k_taps):
    assert weight_block(o, k_taps) == j_weight_block(o, k_taps)
    for p in (1, 100, 128, 401408):
        assert resolve_bsr_tile(o, k_taps) == j_resolve_bsr_tile(o, k_taps, p)[:2]
        got, want = bsr_conv_launch(o, k_taps, p), j_bsr_conv_launch(o, k_taps, p)
        assert vars(got) == {f: getattr(want, f) for f in vars(got)}


@pytest.mark.parametrize("shape,block", [((13, 50), (8, 16)), ((64, 576), (8, 128)),
                                         ((6, 25), (8, 8)), ((24, 144), (8, 32))])
@pytest.mark.parametrize("density", [0.0, 0.3, 0.5, 1.0])
def test_prune_matrix_matches_reference(shape, block, density):
    m = np.random.default_rng(shape[1]).standard_normal(shape).astype(np.float32)
    want, wk, wt = j_prune_matrix(m, density, block)
    got, gk, gt = prune_matrix(_t(m), density, block)
    assert (gk, gt) == (wk, wt)
    assert np.array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(block_norms(_t(m), block).numpy(),
                               np.asarray(j_block_norms(m, block)), rtol=1e-6)


@pytest.mark.parametrize("c,hw,k,stride", [(3, 9, 3, 1), (2, 15, 11, 4), (4, 10, 5, 2)])
def test_extract_windows_matches_reference(c, hw, k, stride):
    from repro.core.sparsity import extract_windows as j_extract_windows
    from repro_torch.core.sparsity import extract_windows

    x = np.random.default_rng(c + hw).standard_normal((c, hw, hw)).astype(np.float32)
    want = np.asarray(j_extract_windows(jnp.asarray(x), k, k, stride))
    assert np.array_equal(extract_windows(_t(x), k, k, stride).numpy(), want)


def test_prune_graph_params_can_leave_the_head_dense():
    jg, tg, jp, tp, _ = _setup("vgg-tiny")
    jpruned, jrep = j_prune_graph_params(jp, 0.3, jg, prune_dense=False)
    pruned, rep = prune_graph_params(tp, 0.3, tg, prune_dense=False)
    assert [s.name for s in rep.layers] == [s.name for s in jrep.layers] == \
        ["conv_1", "conv_2", "conv_3"]
    assert rep.density == jrep.density
    assert all(a is b for a, b in zip(pruned["dense"], tp["dense"]))


def test_prune_matrix_zeros_whole_blocks_lowest_norm_first():
    bt, bf = 8, 16
    m = np.ones((2 * bt, 4 * bf), np.float32)
    m[:bt, :bf] = 0.01  # weakest block
    m[:bt, bf:2 * bf] = 0.1  # second weakest
    pruned, kept, total = prune_matrix(_t(m), 0.75, (bt, bf))
    assert (kept, total) == (6, 8)
    assert float(pruned[:bt, :2 * bf].abs().max()) == 0.0
    assert torch.equal(pruned[bt:], _t(m)[bt:])


def test_prune_matrix_never_counts_dead_blocks_as_kept():
    """Re-pruning already-pruned weight reports the live density, as in the
    reference, not the nominal top-k size."""
    m = _t(np.random.default_rng(3).standard_normal((16, 64)))
    half, _, _ = prune_matrix(m, 0.5, (8, 16))  # 4 of 8 blocks dead
    same, kept, total = prune_matrix(half, 1.0, (8, 16))
    assert torch.equal(same, half) and (kept, total) == (4, 8)
    again, kept, _ = prune_matrix(half, 0.75, (8, 16))  # top-6 incl dead
    assert kept == 4 and torch.equal(again, half)
    want, wk, _ = j_prune_matrix(half.numpy(), 0.75, (8, 16))
    assert wk == kept and np.array_equal(np.asarray(want), again.numpy())


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_prune_graph_params_matches_reference(name):
    jg, tg, jp, tp, calib = _setup(name)
    jpruned, jrep = j_prune_graph_params(jp, 0.3, jg, per_layer={0: 1.0},
                                         probe=jnp.asarray(calib))
    pruned, rep = prune_graph_params(tp, 0.3, tg, per_layer={0: 1.0},
                                     probe=torch.from_numpy(calib))
    assert [(s.name, s.shape, s.block, s.kept_blocks, s.total_blocks,
             s.achieved_density, s.target_density) for s in rep.layers] == \
        [(s.name, s.shape, s.block, s.kept_blocks, s.total_blocks,
          s.achieved_density, s.target_density) for s in jrep.layers]
    assert rep.density == jrep.density
    assert rep.by_name()["conv_1"].achieved_density == 1.0  # override honored
    for kind in ("conv", "dense"):
        for a, b in zip(pruned[kind], jpruned[kind]):
            assert np.array_equal(a.numpy(), np.asarray(b))
    assert rep.top1_agreement == jrep.top1_agreement
    assert rep.max_logit_drift == pytest.approx(jrep.max_logit_drift, rel=1e-4, abs=1e-6)
    for w, s in zip(pruned["conv"], rep.layers):
        assert weight_block_density(w) == pytest.approx(s.achieved_density, abs=1e-9)


# ---------------------------------------------------------------------------
# schedules and the block-sparse matmul
# ---------------------------------------------------------------------------


def _pruned_matrix(t, f, bf, density, seed):
    m = np.random.default_rng(seed).standard_normal((t, f)).astype(np.float32)
    pruned, _, _ = j_prune_matrix(m, density, (8, bf))
    return np.asarray(pruned)


@pytest.mark.parametrize("t,f,bf", [(6, 25, 8), (64, 27, 8), (24, 144, 32), (16, 576, 128)])
def test_block_schedule_matches_reference(t, f, bf):
    h = _pruned_matrix(t, f, bf, 0.3, seed=t + f)
    hp = np.pad(h, ((0, (-t) % 8), (0, (-f) % bf)))
    jids, jcnt = j_block_schedule(jnp.asarray(hp), 8, bf)
    ids, cnt = block_schedule(_t(h), 8, bf)  # the port pads ragged h itself
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    assert np.array_equal(cnt.numpy(), np.asarray(jcnt))
    assert schedule_occupancy(_t(hp), 8, bf) == j_schedule_occupancy(jnp.asarray(hp), 8, bf)


@pytest.mark.parametrize("t,f,d", [(16, 256, 384), (24, 256, 128)])
def test_sparse_matmul_matches_reference(t, f, d):
    h = _pruned_matrix(t, f, 128, 0.4, seed=f)
    h[:8] = 0.0  # an all-pruned row-block: cnt = 0
    w = np.random.default_rng(d).standard_normal((f, d)).astype(np.float32)
    want = np.asarray(j_sparse_matmul(jnp.asarray(h), jnp.asarray(w)))
    got = sparse_matmul(_t(h), _t(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert np.all(got[:8] == 0.0)
    ids, cnt = block_schedule(_t(h), 8, 128)
    sched = bsr_matmul_schedule_ref(_t(h), _t(w), ids, cnt, (8, 128, 128)).numpy()
    np.testing.assert_allclose(sched, bsr_matmul_ref(_t(h), _t(w)).numpy(),
                               rtol=0, atol=1e-5 * np.abs(want).max())


def test_bsr_plain_version_honors_the_schedule():
    """A live block that the schedule leaves out contributes nothing."""
    h = _t(np.random.default_rng(0).standard_normal((8, 32)))
    w = _t(np.random.default_rng(1).standard_normal((32, 5)))
    ids = torch.tensor([[2, 0, 1, 3]], dtype=torch.int32)
    cnt = torch.tensor([1], dtype=torch.int32)
    got = bsr_matmul(h, w, ids, cnt, block=(8, 8))
    want = h[:, 16:24] @ w[16:24]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# conv2d_bsr against the JAX package's Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,c,o,hw,k,stride", [
    (2, 16, 16, 12, 3, 1),   # dividing shapes
    (2, 3, 24, 20, 5, 2),    # K = 75, stride 2
    (1, 8, 6, 9, 3, 1),      # O = 6 (< one row-block), single image
    (2, 3, 8, 23, 11, 4),    # K = 363, stride 4, k 11
    (3, 3, 64, 10, 3, 1),    # K = 27 (VGG-19 conv1_1), P = 192 (ragged)
])
@pytest.mark.parametrize("density", [1.0, 0.3])
def test_conv2d_bsr_matches_reference(n, c, o, hw, k, stride, density):
    rng = np.random.default_rng(n * c * o + hw)
    w = rng.standard_normal((o, c, k, k)).astype(np.float32) * 0.1
    mat = w.reshape(o, -1)
    w = np.asarray(j_prune_matrix(mat, density, j_weight_block(*mat.shape))[0]).reshape(w.shape)
    x = rng.random((n, c, hw, hw), dtype=np.float32)
    want = np.asarray(j_conv2d_bsr(jnp.asarray(x), jnp.asarray(w), stride=stride))
    got = conv2d_bsr(_t(x), _t(w), stride=stride).numpy()
    atol = 1e-5 * np.abs(want).max()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_allclose(conv2d_bsr_ref(_t(x), _t(w), stride).numpy(), want,
                               rtol=0, atol=atol)
    single = conv2d_bsr(_t(x[0]), _t(w), stride=stride).numpy()
    np.testing.assert_allclose(single, want[0], rtol=0, atol=atol)


def test_conv2d_bsr_fully_pruned_weights_give_zero():
    x = _t(np.random.default_rng(0).standard_normal((8, 10, 10)))
    assert float(conv2d_bsr(x, torch.zeros(8, 8, 3, 3)).abs().max()) == 0.0


# ---------------------------------------------------------------------------
# registry and cost model
# ---------------------------------------------------------------------------


def test_registry_bsr_op_flags():
    op = get_op("conv", "bsr")
    assert op.weight_sparse and not op.sparse and not op.quantized
    assert op.fused_with is None


@pytest.mark.parametrize("wd", [1.0, 0.3, 0.05])
def test_bsr_cost_hook_matches_reference(wd):
    for args in [(64, 226, 226, 64, 3, 3), (3, 227, 227, 64, 11, 11), (512, 16, 16, 512, 3, 3)]:
        stride = 4 if args[4] == 11 else 1
        assert bsr_conv_cost(*args, stride=stride, weight_density=wd, batch=8) == \
            j_bsr_conv_cost(*args, stride=stride, weight_density=wd, batch=8)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_unit_model_us_matches_reference(name, reference_roofline):
    jg, tg, *_ = _setup(name)
    for ju, tu in zip(jg.units(), tg.units()):
        for kind, impl in [("conv", "dense"), ("conv", "ecr_pallas"), ("conv", "bsr")]:
            kw = dict(occupancy=0.4, weight_density=0.3, batch=2)
            assert unit_model_us(kind, impl, tu, **kw) == j_unit_model_us(kind, impl, ju, **kw)


def test_bsr_cost_scales_with_weight_density_not_occupancy():
    unit = serving_units()[0]
    us = [unit_model_us("conv", "bsr", unit, weight_density=d) for d in (1.0, 0.5, 0.1)]
    assert us[0] > us[1] > us[2]
    a = unit_model_us("conv", "bsr", unit, occupancy=0.1, weight_density=0.5)
    b = unit_model_us("conv", "bsr", unit, occupancy=1.0, weight_density=0.5)
    assert a == b


def serving_units():
    from repro_torch.launch.serve_cnn import serving_graph

    return serving_graph("vgg19").units()


def _bsr_decision(unit, occ, wd, occ_threshold=0.75, batch=2):
    """The planner's BSR arm for one unit at a given occupancy."""
    from repro_torch.graph.registry import fusion_eligible

    if occ <= occ_threshold:
        kind, impl = ("conv_pool", "pecr_pallas") if fusion_eligible(unit) \
            else ("conv", "ecr_pallas")
    else:
        kind, impl = "conv", "dense"
    base = unit_model_us(kind, impl, unit, occupancy=occ, batch=batch)
    bsr = unit_model_us("conv", "bsr", unit, weight_density=wd, batch=batch)
    return "bsr" if bsr < base else impl


def test_h100_and_reference_defaults_place_pruned_vgg19(monkeypatch):
    """Where the port's H100 defaults and the JAX package's defaults send the
    served VGG-19 (224 px, batch-2 calibration, occ_threshold 0.75) pruned
    to 0.3 to different impls: the BSR arm is priced for every layer at
    every occupancy from 0 to 1 in steps of 0.01 (shapes only; no network
    runs). They disagree only on the five pool-fused layers, where the H100
    defaults (a lower FLOP-to-byte ridge) take BSR over PECR at occupancies
    just above the 0.3 weight density, up to the occupancy pinned here per
    layer, and the reference keeps PECR."""
    import math

    units = vgg19_graph(CNNConfig()).units()
    grid = [i / 100 for i in range(101)]

    def decisions():
        out = []
        for u in units:
            k_taps = u.in_shape[0] * u.conv.k * u.conv.k
            bf = weight_block(u.conv.c_out, k_taps)[1]
            total = math.ceil(u.conv.c_out / 8) * math.ceil(k_taps / bf)
            wd = math.ceil(0.3 * total) / total
            out.append([_bsr_decision(u, occ, wd) for occ in grid])
        return out

    h100 = decisions()
    monkeypatch.setattr(constants, "DEFAULT_ROOFLINE", constants.RooflineConstants(
        j_constants.DEFAULT_PEAK_FLOPS, j_constants.DEFAULT_HBM_BW))
    reference = decisions()
    differ = {}
    for i, u in enumerate(units):
        for j, occ in enumerate(grid):
            if h100[i][j] != reference[i][j]:
                assert (h100[i][j], reference[i][j]) == ("bsr", "pecr_pallas")
                assert 0.3 < occ <= 0.75
                differ.setdefault(u.index + 1, []).append(occ)
    assert {k: (min(v), max(v)) for k, v in differ.items()} == {
        2: (0.31, 0.75), 4: (0.31, 0.75), 8: (0.31, 0.55), 12: (0.31, 0.36),
        16: (0.31, 0.45)}
    # under the H100 defaults every layer goes BSR above its weight density
    # (0.3 to 0.3125: conv1's 32 blocks keep 10)
    assert all(row[32:] == ["bsr"] * 69 for row in h100)


# ---------------------------------------------------------------------------
# pruned planning on the three tiny graphs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("density", [0.3, 1.0])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_pruned_plan_matches_reference(name, density, reference_roofline):
    """int8 off; the same cases with int8 on are
    `test_torch_quant.py::test_int8_plan_matches_reference`."""
    jg, tg, jp, _, calib = _setup(name)
    if density < 1.0:
        jp, _ = j_prune_graph_params(jp, density, jg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    jplan = j_plan_network(jp, jnp.asarray(calib), jg, block_c=8)
    plan = plan_network(tp, torch.from_numpy(calib), tg, block_c=8)
    assert [(lp.kind, lp.impl) for lp in plan.layers] == \
        [(lp.kind, lp.impl) for lp in jplan.layers]
    for a, b in zip(plan.layers, jplan.layers):
        assert a.weight_density == b.weight_density
        assert a.occupancy == pytest.approx(b.occupancy, abs=1e-6)
    assert plan.counts() == jplan.counts()
    assert (plan.counts()["bsr"] >= 1) == (density < 1.0)
    want = np.asarray(j_run_plan(jplan, jp, jnp.asarray(calib)))
    got = run_plan(plan, tp, torch.from_numpy(calib)).numpy()
    _close_logits(got, want)
    _close_logits(got, run_graph(tg, tp, torch.from_numpy(calib), "dense").numpy())


def test_bsr_threshold_gates_selection():
    jg, tg, jp, _, calib = _setup("vgg-tiny")
    jp, _ = j_prune_graph_params(jp, 0.3, jg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    plan = plan_network(tp, torch.from_numpy(calib), tg, block_c=8, bsr_threshold=0.0)
    assert plan.counts()["bsr"] == 0
