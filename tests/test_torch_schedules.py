"""Parity of the port's schedule primitives with the JAX package: block
occupancy, compaction, (ids, cnt) schedules, block-size resolution and the
occupancy statistic must agree EXACTLY (identical plans and summation
orders depend on them). Inputs are made with numpy from a seed and handed
to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.ecr import compact_live_channels as j_compact  # noqa: E402
from repro.core.ecr import compact_live_channels_batch as j_compact_batch  # noqa: E402
from repro.core.sparsity import block_occupancy as j_block_occ  # noqa: E402
from repro.core.sparsity import compact_block_ids as j_compact_ids  # noqa: E402
from repro.core.sparsity import dead_channel_band as j_dead_band  # noqa: E402
from repro.kernels.ecr_conv.ops import batch_block_schedule as j_schedule  # noqa: E402
from repro.kernels.tiles import TileConfig as JTile  # noqa: E402
from repro.kernels.tiles import resolve_block_c as j_resolve_bc  # noqa: E402
from repro.kernels.tiles import resolve_conv_tile as j_resolve_tile  # noqa: E402
from repro.pipeline.planner import occupancy_stat as j_occ_stat  # noqa: E402
from repro_torch.core.ecr import compact_live_channels, compact_live_channels_batch  # noqa: E402
from repro_torch.core.sparsity import block_occupancy, compact_block_ids, dead_channel_band  # noqa: E402
from repro_torch.kernels.ecr_conv.ops import batch_block_schedule  # noqa: E402
from repro_torch.kernels.tiles import TileConfig, resolve_block_c, resolve_conv_tile  # noqa: E402
from repro_torch.pipeline.planner import occupancy_stat  # noqa: E402


def _batch(seed, n=4, c=20, h=6, w=6, zero_sample=True):
    """(N,C,H,W) post-ReLU-like maps: random dead channels per sample (so
    per-sample schedules are ragged), element sparsity on the rest, and
    optionally an all-zero sample (a batcher pad: cnt = 0)."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, c, h, w), dtype=np.float32)
    x *= rng.random((n, c, h, w)) > 0.3
    x *= (rng.random((n, c, 1, 1)) > 0.5)
    if zero_sample:
        x[-1] = 0.0
    return x


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("block", [(6, 6, 4), (2, 3, 5), (3, 6, 20)])
def test_block_occupancy_matches(block):
    x = _batch(1).transpose(0, 2, 3, 1)  # NHWC
    want = np.asarray(j_block_occ(jnp.asarray(x), block))
    got = _np(block_occupancy(torch.from_numpy(x), block))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_block_ids_matches(seed):
    rng = np.random.default_rng(seed)
    for occ in (rng.random(9) > 0.5, np.zeros(9, bool), np.ones(9, bool)):
        ids_j, cnt_j = j_compact_ids(jnp.asarray(occ))
        ids_t, cnt_t = compact_block_ids(torch.from_numpy(occ))
        np.testing.assert_array_equal(_np(ids_t), np.asarray(ids_j))
        assert int(cnt_t) == int(cnt_j)
        assert ids_t.dtype == torch.int32 and cnt_t.dtype == torch.int32


def test_compact_live_channels_matches():
    x = _batch(3, zero_sample=False)
    k = np.random.default_rng(4).standard_normal((5, 20, 3, 3)).astype(np.float32)
    xj, kj, nj = j_compact(jnp.asarray(x[0]), jnp.asarray(k))
    xt, kt, nt = compact_live_channels(torch.from_numpy(x[0]), torch.from_numpy(k))
    np.testing.assert_array_equal(_np(xt), np.asarray(xj))
    np.testing.assert_array_equal(_np(kt), np.asarray(kj))
    assert int(nt) == int(nj)
    xj, kj, nj = j_compact_batch(jnp.asarray(x), jnp.asarray(k))
    xt, kt, nt = compact_live_channels_batch(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_array_equal(_np(xt), np.asarray(xj))
    np.testing.assert_array_equal(_np(kt), np.asarray(kj))
    assert int(nt) == int(nj)


@pytest.mark.parametrize("c,bc", [(20, 4), (20, 8), (16, 8), (12, 16)])
def test_batch_block_schedule_matches(c, bc):
    """Per-sample (ids, cnt) after shared-union compaction and channel
    padding — including C % bc != 0 and the all-zero sample (cnt = 0)."""
    x = _batch(5, c=c)
    k = np.zeros((4, c, 3, 3), np.float32)
    xj, _, _ = j_compact_batch(jnp.asarray(x), jnp.asarray(k))
    xt, _, _ = compact_live_channels_batch(torch.from_numpy(x), torch.from_numpy(k))
    cp = (-c) % bc
    xj = jnp.pad(xj, ((0, 0), (0, cp), (0, 0), (0, 0))).transpose(0, 2, 3, 1)
    xt = torch.nn.functional.pad(xt, (0, 0, 0, 0, 0, cp)).permute(0, 2, 3, 1)
    ids_j, cnt_j = j_schedule(xj, 6, 6, bc)
    ids_t, cnt_t = batch_block_schedule(xt, 6, 6, bc)
    np.testing.assert_array_equal(_np(ids_t), np.asarray(ids_j))
    np.testing.assert_array_equal(_np(cnt_t), np.asarray(cnt_j))
    assert int(cnt_t[-1]) == 0  # the all-zero sample schedules nothing


@pytest.mark.parametrize("h,w,c,o,tile", [
    (224, 224, 3, 64, None), (226, 226, 64, 64, None), (58, 58, 256, 256, None),
    (16, 16, 16, 16, (8, 0)), (16, 16, 20, 16, (32, 0)), (12, 12, 24, 24, (0, 0)),
    (30, 30, 7, 5, (5, 3)), (600, 600, 512, 512, None), (9, 9, 300, 64, (0, 16)),
])
def test_resolve_block_c_and_conv_tile_match(h, w, c, o, tile):
    tj = JTile(block_c=tile[0], block_o=tile[1]) if tile else None
    tt = TileConfig(block_c=tile[0], block_o=tile[1]) if tile else None
    assert resolve_block_c(h, w, c, tt) == j_resolve_bc(h, w, c, tj)
    assert resolve_conv_tile(h, w, c, o, tt) == j_resolve_tile(h, w, c, o, tj)


@pytest.mark.parametrize("block_c", [0, 8, 6])
@pytest.mark.parametrize("n_valid", [None, 0, 2, 4])
def test_occupancy_stat_matches(block_c, n_valid):
    """With and without n_valid (0 = a bucket of pure pads, N = all real)."""
    x = _batch(7)
    want = float(j_occ_stat(jnp.asarray(x), block_c, n_valid))
    got = float(occupancy_stat(torch.from_numpy(x), block_c, n_valid))
    assert got == pytest.approx(want, abs=1e-6)


def test_dead_channel_band_matches():
    x = _batch(8, zero_sample=False)[0]
    for frac in (0.0, 0.25, 0.5, 0.9):
        np.testing.assert_array_equal(
            _np(dead_channel_band(torch.from_numpy(x), frac)),
            np.asarray(j_dead_band(jnp.asarray(x), frac)))


def test_as_tile_matches():
    from repro.kernels.tiles import as_tile as j_as_tile
    from repro_torch.kernels.tiles import as_tile

    for bc in (0, 8, 24):
        assert as_tile(None, bc).key() == j_as_tile(None, bc).key()[:2]
    assert as_tile(TileConfig(block_c=4, block_o=16), 8) == TileConfig(4, 16)


@pytest.mark.parametrize("args", [
    (16, 18, 18, 32, 3, 3, 1, 0.5, 4), (3, 228, 228, 64, 11, 11, 4, 1.0, 8),
    (6, 14, 14, 16, 5, 5, 1, 0.25, 2),
])
def test_cost_hooks_match(args):
    from repro.kernels.conv_pool.ops import conv_pool_cost as j_pool_cost
    from repro.kernels.ecr_conv.ops import ecr_conv_cost as j_cost
    from repro_torch.kernels.conv_pool.ops import conv_pool_cost
    from repro_torch.kernels.ecr_conv.ops import ecr_conv_cost

    c, h, w, o, kh, kw, s, occ, n = args
    kws = dict(stride=s, occupancy=occ, batch=n)
    assert ecr_conv_cost(c, h, w, o, kh, kw, **kws) == j_cost(c, h, w, o, kh, kw, **kws)
    assert conv_pool_cost(c, h, w, o, kh, kw, pool=2, **kws) == \
        j_pool_cost(c, h, w, o, kh, kw, pool=2, **kws)


def test_fusion_rule_and_unit_impl_match():
    """The registry's fusion rule on every unit of the three tiny graphs and
    the full AlexNet (overlapping pools) resolves identically."""
    from repro.configs.alexnet import ALEXNET as JA
    from repro.configs.alexnet import ALEXNET_REDUCED as JAR
    from repro.configs.lenet import LENET_REDUCED as JL
    from repro.graph.registry import fusion_eligible as j_fusion
    from repro.graph.registry import unit_impl as j_unit_impl
    from repro_torch.configs.alexnet import ALEXNET, ALEXNET_REDUCED
    from repro_torch.configs.lenet import LENET_REDUCED
    from repro_torch.graph.registry import fusion_eligible, unit_impl

    for tg, jg in ((ALEXNET, JA), (ALEXNET_REDUCED, JAR), (LENET_REDUCED, JL)):
        for tu, ju in zip(tg.units(), jg.units()):
            assert fusion_eligible(tu) == j_fusion(ju)
            for impl in ("dense", "ecr_pallas", "pecr_pallas"):
                assert unit_impl(tu, impl) == j_unit_impl(ju, impl)


def test_schedule_guard_clamps_only_when_enabled(monkeypatch):
    from repro_torch.kernels.schedule_guard import guard_schedule

    ids = torch.tensor([[0, 7, -1]], dtype=torch.int32)
    cnt = torch.tensor([5], dtype=torch.int32)
    monkeypatch.delenv("REPRO_CHECK_SCHEDULES", raising=False)
    assert guard_schedule(ids, cnt, 3) == (ids, cnt)
    monkeypatch.setenv("REPRO_CHECK_SCHEDULES", "1")
    gi, gc = guard_schedule(ids, cnt, 3)
    assert gi.tolist() == [[0, 2, 0]] and gc.tolist() == [3]
    assert gi.dtype == torch.int32 and gc.dtype == torch.int32


@pytest.mark.parametrize("ids,cnt,refused", [
    ([[1, 1]], [2], [True]),  # block 1 listed twice among the live lanes
    ([[1, 1]], [1], [False]),  # the repeat is a padding lane
    ([[0, 7, -1]], [5], [False]),  # out-of-range ids are clamped, not repeats
    ([[2, 0, 1], [1, 2, 1]], [3, 3], [False, True]),
    ([0, 1, 2], 3, [False]),  # the single-image ECR form: (n_cb,) with a scalar cnt
])
def test_schedule_guard_refuses_a_repeated_block(monkeypatch, ids, cnt, refused):
    from repro_torch.kernels.schedule_guard import guard_schedule, repeated_blocks

    ids = torch.tensor(ids, dtype=torch.int32)
    cnt = torch.tensor(cnt, dtype=torch.int32)
    assert repeated_blocks(ids, cnt, 3).tolist() == refused
    monkeypatch.delenv("REPRO_CHECK_SCHEDULES", raising=False)
    assert guard_schedule(ids, cnt, 3) == (ids, cnt)
    monkeypatch.setenv("REPRO_CHECK_SCHEDULES", "1")
    if any(refused):
        with pytest.raises(ValueError, match="more than once"):
            guard_schedule(ids, cnt, 3)
    else:
        guard_schedule(ids, cnt, 3)


def test_schedule_guard_passes_the_schedules_the_port_makes(monkeypatch):
    """The guard refuses no schedule the port builds: BSR's block schedule
    of a pruned weight matrix and ECR's per-sample channel-block schedules."""
    from repro_torch.kernels.bsr_matmul.ops import block_schedule
    from repro_torch.kernels.schedule_guard import guard_schedule

    monkeypatch.setenv("REPRO_CHECK_SCHEDULES", "1")
    rng = np.random.default_rng(3)
    keep = np.repeat(np.repeat(rng.random((5, 6)) < 0.5, 8, 0), 16, 1)
    h = torch.from_numpy((rng.standard_normal((40, 96)) * keep).astype(np.float32))
    ids, cnt = block_schedule(h, 8, 16)
    assert int(cnt.max()) > 0
    gi, gc = guard_schedule(ids, cnt, 6)
    assert torch.equal(gi, ids) and torch.equal(gc, cnt)
    x = torch.from_numpy(rng.standard_normal((2, 6, 6, 32)).astype(np.float32))
    x[0, :, :, 8:24] = 0.0
    ids, cnt = batch_block_schedule(x, 6, 6, 8)
    gi, gc = guard_schedule(ids, cnt, 4)
    assert torch.equal(gi, ids) and torch.equal(gc, cnt)
