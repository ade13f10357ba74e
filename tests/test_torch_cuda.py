"""The CUDA kernels against their plain PyTorch versions on the card. These
tests need an NVIDIA GPU and nvcc; without a card they skip (the check runs
inside the fixture, never at import). Run them on the card with
`PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`
(`tests/conftest.py` imports JAX, which the card's machine need not have).

Tolerances: fp32 kernels max|kernel - plain| <= 1e-4 * max|plain|
+ 1e-5 * min(1, max|plain|) (the floor shrinks with small outputs) —
fp32 sums in another order (the conv kernel per 8-channel step then per tap,
in split-TF32 on the tensor cores, three TF32 products per multiply-add; its
plain version one matmul per tap over every scheduled channel; the BSR kernel
block by block, in split-TF32 too, its plain version one matmul; the flash
kernels tile by tile with an online softmax (the fp32 one in split-TF32, four
warps' partial softmaxes combined), their plain versions in one pass, for
out, m and l). int8 kernels: bitwise equal —
both sum the same integers exactly (int32 in the kernel, float64 in the plain
version) and rescale in the same order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.bsr_matmul.kernel import bsr_matmul, bsr_matmul_plain  # noqa: E402
from repro_torch.kernels.bsr_matmul.ops import block_schedule  # noqa: E402
from repro_torch.kernels.conv_pool.kernel import conv_pool_batch, conv_pool_plain  # noqa: E402
from repro_torch.kernels.conv_pool.ops import conv_pool_launch  # noqa: E402
from repro_torch.kernels.ecr_conv.kernel import ecr_conv_batch, ecr_conv_plain  # noqa: E402
from repro_torch.kernels.ecr_conv.ops import ecr_conv_launch, pack_operands  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_fwd,
    flash_fwd_plain,
    flash_fwd_q8,
    flash_fwd_q8_plain,
)
from repro_torch.models.attention import _quantize_kv  # noqa: E402
from repro_torch.quant.kernels import (  # noqa: E402
    bsr_matmul_int8,
    bsr_matmul_int8_plain,
    ecr_conv_int8_batch,
    ecr_conv_int8_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.device import strict_fp32

    strict_fp32()
    return torch.device("cuda")


def _close(got, want):
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    assert err <= 1e-4 * scale + 1e-5 * min(1.0, scale), (err, scale)


def _packed(dev, n, c, hw, o, k, stride, pool, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((n, c, hw, hw), dtype=np.float32)
    x *= rng.random((n, c, 1, 1)) > 0.4
    x[-1] = 0.0  # a pad sample: cnt = 0
    w = rng.standard_normal((o, c, k, k)).astype(np.float32)
    make = conv_pool_launch if pool else ecr_conv_launch
    kws = dict(stride=stride, block_c=8, batch=n)
    if pool:
        kws["pool"] = pool
    launch = make(c, hw, hw, o, k, k, **kws)
    xt, wt = torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)
    return pack_operands(xt, wt, launch), launch.block_c


@pytest.mark.parametrize("n,c,hw,o,k,stride", [
    (4, 20, 17, 70, 3, 1), (3, 3, 227, 64, 11, 4), (2, 6, 14, 16, 5, 1),
    (3, 64, 31, 192, 5, 1), (2, 16, 15, 8, 3, 2), (8, 256, 58, 256, 3, 1),
])
def test_ecr_kernel_matches_plain(dev, n, c, hw, o, k, stride):
    (x, w, ids, cnt), bc = _packed(dev, n, c, hw, o, k, stride, 0, seed=hw + k)
    before = ecr_conv_batch.launches
    got = ecr_conv_batch(x, w, ids, cnt, stride=stride, block_c=bc)
    torch.cuda.synchronize()
    assert ecr_conv_batch.launches == before + 1
    _close(got, ecr_conv_plain(x, w, ids, cnt, stride=stride, block_c=bc))
    assert torch.all(got[-1] == 0)


@pytest.mark.parametrize("n,c,hw,o,k,stride", [
    (4, 20, 18, 70, 3, 1), (2, 6, 14, 16, 5, 1), (3, 16, 29, 64, 3, 1),
    (8, 512, 30, 512, 3, 1),
])
def test_pecr_kernel_matches_plain(dev, n, c, hw, o, k, stride):
    (x, w, ids, cnt), bc = _packed(dev, n, c, hw, o, k, stride, 2, seed=hw + 2 * k)
    before = conv_pool_batch.launches
    got = conv_pool_batch(x, w, ids, cnt, stride=stride, pool=2, block_c=bc)
    torch.cuda.synchronize()
    assert conv_pool_batch.launches == before + 1
    _close(got, conv_pool_plain(x, w, ids, cnt, stride=stride, pool=2, block_c=bc))
    assert torch.all(got[-1] == 0)


def _run_conv(dev, x, w, ids, cnt, bc, pool):
    """Kernel vs plain within the fp32 limit, one launch counted, and every
    cnt = 0 sample all zeros."""
    wrapper = conv_pool_batch if pool else ecr_conv_batch
    before = wrapper.launches
    if pool:
        got = conv_pool_batch(x, w, ids, cnt, stride=1, pool=pool, block_c=bc)
        want = conv_pool_plain(x, w, ids, cnt, stride=1, pool=pool, block_c=bc)
    else:
        got = ecr_conv_batch(x, w, ids, cnt, stride=1, block_c=bc)
        want = ecr_conv_plain(x, w, ids, cnt, stride=1, block_c=bc)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _close(got, want)
    for b in (cnt == 0).nonzero().flatten().tolist():
        assert torch.all(got[b] == 0)
    assert float(want.abs().max()) > 0


def _f32_operands(dev, rng, n, h, w_, c, o):
    x = torch.from_numpy(rng.random((n, h, w_, c), dtype=np.float32)).to(dev)
    w = (rng.standard_normal((3, 3, c, o)) / np.sqrt(9 * c)).astype(np.float32)
    return x, torch.from_numpy(w).to(dev)


# The split-TF32 kernel's k-steps are 8 channels: block_c 4 packs two
# scheduled blocks per step (an odd cnt leaves half a step, zero-filled),
# block_c 16 takes two steps per block; O = 70 is not a multiple of 4 (plain
# weight loads) nor of the tile.
@pytest.mark.parametrize("bc,o,pool", [(8, 96, 0), (8, 70, 2), (16, 128, 0), (4, 64, 2),
                                       (4, 70, 0), (16, 64, 2)])
def test_ecr_kernel_schedule_tails(dev, bc, o, pool):
    """cnt 1, 2, 3 and n_cb, cnt = 0, ids out of order."""
    rng = np.random.default_rng(bc + o + pool)
    cnts = [1, 2, 3, 8, 0, 5]
    x, w = _f32_operands(dev, rng, len(cnts), 13, 19, 8 * bc, o)
    ids = torch.from_numpy(np.stack([rng.permutation(8) for _ in cnts]).astype(np.int32))
    cnt = torch.tensor(cnts, dtype=torch.int32)
    _run_conv(dev, x, w, ids.to(dev), cnt.to(dev), bc, pool)


def test_ecr_kernel_single_image(dev):
    """N=1 at a VGG-19 conv13 shape (1x16x16x512 -> 512), 36 of 64 blocks
    live as an identity prefix (the single-image schedule): the kernel's
    smallest served grid."""
    rng = np.random.default_rng(13)
    x, w = _f32_operands(dev, rng, 1, 16, 16, 512, 512)
    x[..., 36 * 8:] = 0.0
    ids = torch.arange(64, dtype=torch.int32, device=dev)[None].contiguous()
    cnt = torch.tensor([36], dtype=torch.int32, device=dev)
    _run_conv(dev, x, w, ids, cnt, 8, 0)


@pytest.mark.parametrize("pool", [0, 2])
def test_ecr_kernel_at_served_batch(dev, pool):
    """The served conv10 (pool 0) and conv12 (pool 2) shapes at batch 8:
    28x28 maps padded to 30, 512 -> 512 channels, 42 of 64 blocks per
    sample in permuted order, the last sample a pad (cnt = 0)."""
    rng = np.random.default_rng(10 + pool)
    x, w = _f32_operands(dev, rng, 8, 30, 30, 512, 512)
    x[-1] = 0.0
    ids = torch.from_numpy(np.stack([rng.permutation(64) for _ in range(8)]).astype(np.int32))
    cnt = torch.tensor([42] * 7 + [0], dtype=torch.int32)
    _run_conv(dev, x, w, ids.to(dev), cnt.to(dev), 8, pool)


# The searched output tile (block_o -> the C entry point's tn): 64 or 128
# columns pin the kernel's NT; 0 keeps the kernel's own choice. Any tile
# sums each output in the same order, so the values are the same function;
# the limit is the fp32 one all the same.
@pytest.mark.parametrize("pool", [0, 2])
@pytest.mark.parametrize("o", [64, 70, 512])
def test_conv_kernel_block_o_matches_the_default(dev, pool, o):
    from repro_torch.kernels.cuda import launch_conv

    rng = np.random.default_rng(o + pool)
    x, w = _f32_operands(dev, rng, 8, 30, 30, 256, o)
    x[-1] = 0.0
    ids = torch.from_numpy(np.stack([rng.permutation(32) for _ in range(8)]).astype(np.int32))
    cnt = torch.tensor([20, 32, 1, 7, 16, 31, 12, 0], dtype=torch.int32)
    ids, cnt = ids.to(dev), cnt.to(dev)
    kw = dict(stride=1, block_c=8, pool=pool)
    default = launch_conv(x, w, ids, cnt, **kw)
    again = launch_conv(x, w, ids, cnt, block_o=0, **kw)
    torch.cuda.synchronize()
    assert torch.equal(default, again)  # block_o=0 is the call without it
    plain = (conv_pool_plain(x, w, ids, cnt, stride=1, pool=pool, block_c=8) if pool
             else ecr_conv_plain(x, w, ids, cnt, stride=1, block_c=8))
    _close(default, plain)
    for bo in (64, 128):
        got = launch_conv(x, w, ids, cnt, block_o=bo, **kw)
        torch.cuda.synchronize()
        _close(got, default)
        _close(got, plain)
        assert torch.equal(got, launch_conv(x, w, ids, cnt, block_o=bo, **kw))


@pytest.mark.parametrize("bad", [32, 96, 256, -64])
def test_conv_kernel_refuses_another_block_o(dev, bad):
    from repro_torch.kernels.cuda import launch_conv

    x = torch.zeros(1, 5, 5, 8, device=dev)
    w = torch.zeros(3, 3, 8, 64, device=dev)
    ids = torch.zeros(1, 1, dtype=torch.int32, device=dev)
    cnt = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="block_o"):
        launch_conv(x, w, ids, cnt, stride=1, block_c=8, block_o=bad)
    with pytest.raises(ValueError, match="block_o"):
        ecr_conv_batch(x, w, ids, cnt, stride=1, block_c=8, block_o=bad)


def test_int8_conv_kernel_refuses_a_block_o(dev):
    from repro_torch.kernels.cuda import launch_conv

    x = torch.zeros(1, 5, 5, 32, dtype=torch.int8, device=dev)
    w = torch.zeros(3, 3, 32, 64, dtype=torch.int8, device=dev)
    ids = torch.zeros(1, 1, dtype=torch.int32, device=dev)
    cnt = torch.ones(1, dtype=torch.int32, device=dev)
    sx = torch.ones(1, device=dev)
    sw = torch.ones(64, device=dev)
    with pytest.raises(ValueError, match="fixed output tile"):
        launch_conv(x, w, ids, cnt, stride=1, block_c=32, sx=sx, sw=sw, block_o=64)


@pytest.mark.parametrize("impl", ["ecr_pallas", "pecr_pallas", "bsr", "ecr_int8", "bsr_int8"])
def test_searched_geometries_on_the_card(dev, impl):
    """Every card-grid geometry of a served-shape layer (28x28, 256 -> 256,
    batch 8, half the channels dead), through run_unit, against the default
    geometry: fp32 within the limit, int8 ECR bitwise (the same integers)."""
    from repro_torch.graph.executor import run_unit
    from repro_torch.graph.ir import ConvSpec, ConvUnit, PoolSpec
    from repro_torch.graph.registry import unit_impl
    from repro_torch.obs.tilesearch import layer_tile_candidates

    rng = np.random.default_rng(3)
    x = rng.random((8, 256, 28, 28), dtype=np.float32)
    x *= rng.random((8, 256, 1, 1)) > 0.5
    w = (rng.standard_normal((256, 256, 3, 3)) / 48.0).astype(np.float32)
    if impl.startswith("bsr"):
        w *= np.repeat(rng.random((32, 18)) > 0.7, 8, 0).repeat(128, 1)[:, :2304].reshape(
            256, 256, 3, 3)
    unit = ConvUnit(index=0, stage=0, slot=0, conv=ConvSpec(256, k=3, stride=1, pad=1),
                    relu=True, pool=PoolSpec(2), in_shape=(256, 28, 28),
                    out_shape=(256, 14, 14))
    kind, impl = unit_impl(unit, impl)
    xt, wt = torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)
    base = run_unit(xt, wt, unit, kind, impl, 8)
    cands = layer_tile_candidates(unit, kind, impl, 8)
    assert len(cands) > 1
    for t in cands[1:]:
        got = run_unit(xt, wt, unit, kind, impl, 8, tile=t)
        torch.cuda.synchronize()
        if impl == "ecr_int8":
            assert torch.equal(got, base), t
        else:
            _close(got, base)


def _tf32_probe_operands(kind: str, seed: int = 0):
    """The operands of tests/test_torch_kernels.py::tf32_probe_operands (the
    same generator and seed; that file imports JAX and cannot be imported
    here), on which one TF32 product per multiply-add errs by more than
    twice the fp32 limit and split-TF32 stays within 5% of it."""
    rng = np.random.default_rng(seed)
    x = rng.random((1, 18, 18, 512), dtype=np.float32)
    w = (rng.standard_normal((3, 3, 512, 64)) / np.sqrt(4608)).astype(np.float32)
    if kind == "wide":
        x = (x * np.exp2(rng.integers(-12, 13, x.shape))).astype(np.float32)
        w = (w * np.exp2(rng.integers(-12, 13, w.shape))).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


@pytest.mark.parametrize("kind", ["uniform", "wide"])
def test_ecr_kernel_holds_the_fp32_limit_where_tf32_fails(dev, kind):
    """K = 4608 with x and w uniform/normal, or spread over 2^+-12: a kernel
    that dropped the split (one TF32 product) would err by 2-4x the limit."""
    x, w = (t.to(dev) for t in _tf32_probe_operands(kind))
    ids = torch.arange(64, dtype=torch.int32, device=dev)[None].contiguous()
    cnt = torch.tensor([64], dtype=torch.int32, device=dev)
    _run_conv(dev, x, w, ids, cnt, 8, 0)


@pytest.mark.parametrize("pool", [0, 2])
def test_ecr_kernel_off_alignment(dev, pool):
    """x and w 4 bytes past a 16-byte boundary: staged with plain loads
    instead of cp.async, the same results."""
    rng = np.random.default_rng(5 + pool)
    x, w = _f32_operands(dev, rng, 3, 12, 12, 32, 64)

    def misaligned(t):
        buf = torch.empty(t.numel() + 4, device=dev)
        v = buf[1:1 + t.numel()].view(t.shape)
        v.copy_(t)
        return v

    xo, wo = misaligned(x), misaligned(w)
    assert xo.data_ptr() % 16 and wo.data_ptr() % 16
    ids = torch.from_numpy(np.stack([rng.permutation(4) for _ in range(3)]).astype(np.int32))
    cnt = torch.tensor([4, 0, 2], dtype=torch.int32)
    _run_conv(dev, xo, wo, ids.to(dev), cnt.to(dev), 8, pool)


def _bsr_operands(dev, t, f, d, bf, density, seed, dtype=np.float32):
    """A block-pruned h (T,F) with row-block 0 pruned away entirely
    (cnt = 0), a dense w (F,D), and h's schedule."""
    rng = np.random.default_rng(seed)
    nt, nf = -(-t // 8), -(-f // bf)
    keep = rng.random((nt, nf)) < density
    keep[0] = False
    mask = np.repeat(np.repeat(keep, 8, 0), bf, 1)[:t, :f]
    if dtype == np.int8:
        h = rng.integers(-127, 128, (t, f)).astype(np.int8) * mask.astype(np.int8)
        w = rng.integers(-127, 128, (f, d)).astype(np.int8)
    else:
        h = (rng.standard_normal((t, f)) * mask).astype(np.float32)
        w = rng.standard_normal((f, d)).astype(np.float32)
    ht, wt = torch.from_numpy(h).to(dev), torch.from_numpy(w).to(dev)
    ids, cnt = block_schedule(ht, 8, bf)
    assert int(cnt[0]) == 0
    return ht, wt, ids.contiguous(), cnt.contiguous()


# The tensor-core kernels' paths (fp32 and int8): every block width the
# pruner makes with F = 25 and 27 (the ragged last block; bf below the
# staged step goes row by row through the union table), T not a multiple of
# 8, ragged P (16-byte copies of the patch matrix, or narrower ones), 8
# row-blocks per block (grids that fill the card: the served conv10 shape,
# P = 40000) and 2 (smaller grids: conv13's shape).
BSR_SHAPES = [
    (6, 25, 300, 8), (64, 576, 4099, 128), (512, 4608, 300, 128),
    (64, 27, 1000, 8), (70, 25, 333, 16), (24, 27, 257, 32), (16, 25, 130, 64),
    (40, 27, 64, 128), (13, 200, 4096, 16), (512, 4608, 6272, 128),
    (512, 4608, 1568, 128), (64, 27, 40000, 8), (70, 200, 40001, 16),
    (70, 200, 129, 32),
]


def _run_bsr(h, w, ids, cnt, bf):
    """fp32 kernel vs plain within the fp32 limit, one launch counted, every
    cnt = 0 row-block all zeros."""
    before = bsr_matmul.launches
    got = bsr_matmul(h, w, ids, cnt, block=(8, bf))
    torch.cuda.synchronize()
    assert bsr_matmul.launches == before + 1
    want = bsr_matmul_plain(h, w, ids, cnt, block=(8, bf))
    _close(got, want)
    for i in (cnt == 0).nonzero().flatten().tolist():
        assert torch.all(got[8 * i:8 * i + 8] == 0)


@pytest.mark.parametrize("t,f,d,bf", BSR_SHAPES)
def test_bsr_kernel_matches_plain(dev, t, f, d, bf):
    _run_bsr(*_bsr_operands(dev, t, f, d, bf, 0.4, seed=t + f), bf)


@pytest.mark.parametrize("bf", [8, 16, 32, 64, 128])
def test_bsr_kernel_at_served_density(dev, bf):
    """Density 0.3, where every row-block keeps its own blocks (schedules
    differ from row-block to row-block), row-block 0 keeps none."""
    h, w, ids, cnt = _bsr_operands(dev, 256, 1152, 40960, bf, 0.3, seed=bf)
    assert len({tuple(r) for r in ids[cnt > 0].tolist()}) > 1
    _run_bsr(h, w, ids, cnt, bf)


@pytest.mark.parametrize("t,d", [(512, 6272), (512, 1568), (4200, 300)])
def test_bsr_kernel_skewed_row_blocks(dev, t, d):
    """Row-blocks that keep none, all or a few of their blocks, as pruned
    VGG-19 layers do: the kernel deals them to its groups by count (8 or 2
    row-blocks per group), also at a large T (4200: 525 row-blocks)."""
    rng = np.random.default_rng(t + d)
    nt, nf, bf = -(-t // 8), 36 if t == 512 else 8, 128 if t == 512 else 16
    f = nf * bf
    kind = rng.integers(0, 3, nt)  # none, all, a third
    keep = np.where(kind[:, None] == 1, True,
                    np.where(kind[:, None] == 0, False, rng.random((nt, nf)) < 0.3))
    mask = np.repeat(np.repeat(keep, 8, 0), bf, 1)[:t, :f]
    h = torch.from_numpy((rng.standard_normal((t, f)) * mask).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.random((f, d), dtype=np.float32)).to(dev)
    ids, cnt = block_schedule(h, 8, bf)
    _run_bsr(h, w, ids.contiguous(), cnt.contiguous(), bf)


@pytest.mark.parametrize("kind", ["uniform", "wide"])
def test_bsr_kernel_holds_the_fp32_limit_where_tf32_fails(dev, kind):
    """The conv probe lowered as BSR: W (64, 4608) against the patch matrix
    (4608, 256), every block scheduled, x and w uniform/normal or spread over
    2^+-12; one TF32 product per multiply-add errs by more than twice the
    limit there (the host emulation in test_torch_kernels.py)."""
    from repro_torch.core.sparsity import patches_t

    x, w = _tf32_probe_operands(kind)
    at, _, _ = patches_t(x.permute(0, 3, 1, 2), 3, 3)
    h = w.permute(3, 2, 0, 1).reshape(64, -1).contiguous()
    ids, cnt = block_schedule(h, 8, 128)
    _run_bsr(h.to(dev), at.contiguous().to(dev), ids.to(dev), cnt.to(dev), 128)


@pytest.mark.parametrize("t,f,d,bf", BSR_SHAPES)
def test_bsr_int8_kernel_is_bitwise_plain(dev, t, f, d, bf):
    h, w, ids, cnt = _bsr_operands(dev, t, f, d, bf, 0.4, seed=t, dtype=np.int8)
    rng = np.random.default_rng(t)
    sh = torch.from_numpy(rng.random(t).astype(np.float32) * 1e-2 + 1e-4).to(dev)
    sw = torch.tensor([3.7e-3], device=dev)
    before = bsr_matmul_int8.launches
    got = bsr_matmul_int8(h, w, sh, sw, ids, cnt, block=(8, bf))
    torch.cuda.synchronize()
    assert bsr_matmul_int8.launches == before + 1
    assert torch.equal(got, bsr_matmul_int8_plain(h, w, sh, sw, ids, cnt,
                                                  block=(8, bf)))


@pytest.mark.parametrize("bf", [8, 16, 32, 64, 128])
def test_bsr_int8_kernel_at_served_density(dev, bf):
    """Density 0.3, where every row-block keeps its own blocks (schedules
    differ from row-block to row-block), row-block 0 keeps none."""
    h, w, ids, cnt = _bsr_operands(dev, 256, 1152, 40960, bf, 0.3, seed=bf,
                                   dtype=np.int8)
    assert len({tuple(r) for r in ids[cnt > 0].tolist()}) > 1
    sh = torch.rand(256, device=dev) * 1e-2 + 1e-4
    sw = torch.tensor([2.1e-3], device=dev)
    got = bsr_matmul_int8(h, w, sh, sw, ids, cnt, block=(8, bf))
    torch.cuda.synchronize()
    assert torch.equal(got, bsr_matmul_int8_plain(h, w, sh, sw, ids, cnt,
                                                  block=(8, bf)))
    assert torch.all(got[:8] == 0)


def test_bsr_int8_extremes_stay_exact(dev):
    """All +-127 over VGG-19's longest reduction (K = 512 * 9): every
    product is 16129 and the int32 sum reaches 74.3M without overflow."""
    t, f, d = 16, 4608, 256
    h = torch.full((t, f), 127, dtype=torch.int8, device=dev)
    h[8:] = -127
    w = torch.full((f, d), 127, dtype=torch.int8, device=dev)
    ids, cnt = block_schedule(h, 8, 128)
    one = torch.ones(t, device=dev)
    got = bsr_matmul_int8(h, w, one, torch.ones(1, device=dev), ids, cnt,
                          block=(8, 128))
    assert torch.all(got[:8] == float(127 * 127 * f))
    assert torch.all(got[8:] == -float(127 * 127 * f))


def _packed_int8(dev, n, c, hw, o, k, stride, seed, extreme=False):
    rng = np.random.default_rng(seed)
    if extreme:
        x = np.full((n, c, hw, hw), 127, np.int8)
        w = np.full((o, c, k, k), -127, np.int8)
    else:
        x = rng.integers(-127, 128, (n, c, hw, hw)).astype(np.int8)
        x *= (rng.random((n, c, 1, 1)) > 0.4).astype(np.int8)
        w = rng.integers(-127, 128, (o, c, k, k)).astype(np.int8)
    x[-1] = 0  # a pad sample: cnt = 0
    launch = ecr_conv_launch(c, hw, hw, o, k, k, stride=stride, block_c=8,
                             batch=n, dtype_bytes=1)
    xt = torch.from_numpy(x).to(dev)
    wt = torch.from_numpy(w).to(dev)
    xp, wp, ids, cnt = pack_operands(xt, wt, launch)
    sx = torch.from_numpy(rng.random(n).astype(np.float32) * 1e-2 + 1e-4).to(dev)
    sw = torch.from_numpy(rng.random(o).astype(np.float32) * 1e-2 + 1e-4).to(dev)
    return (xp, wp, sx, sw, ids, cnt), launch.block_c


# The tensor-core kernel's paths: O not a multiple of its 128-channel tile
# (70, 16, 192), output maps not a multiple of its spatial tile, 11x11
# stride 4 and 5x5 (taps staged in chunks), conv13-16 at batch 8; N=1 at
# conv13's shape, the kernel's smallest served grid, is its own test below.
@pytest.mark.parametrize("n,c,hw,o,k,stride", [
    (4, 20, 17, 70, 3, 1), (3, 3, 227, 64, 11, 4), (2, 6, 14, 16, 5, 1),
    (8, 256, 58, 256, 3, 1), (1, 64, 30, 64, 3, 1), (2, 64, 37, 192, 3, 1),
    (2, 16, 67, 96, 11, 4), (3, 64, 31, 192, 5, 1), (8, 512, 16, 512, 3, 1),
])
def test_ecr_int8_kernel_is_bitwise_plain(dev, n, c, hw, o, k, stride):
    args, bc = _packed_int8(dev, n, c, hw, o, k, stride, seed=hw + k)
    before = ecr_conv_int8_batch.launches
    got = ecr_conv_int8_batch(*args, stride=stride, block_c=bc)
    torch.cuda.synchronize()
    assert ecr_conv_int8_batch.launches == before + 1
    assert torch.equal(got, ecr_conv_int8_plain(*args, stride=stride, block_c=bc))
    assert torch.all(got[-1] == 0)


@pytest.mark.parametrize("bc,o", [(8, 96), (8, 70), (16, 128), (4, 64)])
def test_ecr_int8_kernel_schedule_tails(dev, bc, o):
    """Schedules the kernel gathers 32 channels at a time from: cnt % (32 /
    bc) of 1, 2 and 3 blocks, cnt = n_cb, cnt = 0, ids out of order."""
    rng = np.random.default_rng(bc + o)
    n_cb = 8
    c = n_cb * bc
    cnts = [1, 2, 3, n_cb, 0, 5]
    x = torch.from_numpy(rng.integers(-127, 128, (len(cnts), 13, 19, c)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (3, 3, c, o)).astype(np.int8))
    ids = np.stack([rng.permutation(n_cb) for _ in cnts]).astype(np.int32)
    args = [t.to(dev) for t in (x, w)]
    sx = torch.from_numpy(rng.random(len(cnts)).astype(np.float32) * 1e-2 + 1e-4).to(dev)
    sw = torch.from_numpy(rng.random(o).astype(np.float32) * 1e-2 + 1e-4).to(dev)
    ids_t = torch.from_numpy(ids).to(dev)
    cnt_t = torch.tensor(cnts, dtype=torch.int32, device=dev)
    got = ecr_conv_int8_batch(*args, sx, sw, ids_t, cnt_t, stride=1, block_c=bc)
    torch.cuda.synchronize()
    assert torch.equal(got, ecr_conv_int8_plain(*args, sx, sw, ids_t, cnt_t,
                                                stride=1, block_c=bc))
    assert torch.all(got[4] == 0)


def test_ecr_int8_kernel_single_image(dev):
    """N=1 at a VGG-19 conv13 shape (1x512x16x16 -> 512), 36 of 64 blocks
    live as an identity prefix (the single-image schedule): a grid of 8
    blocks, each reducing over all 36 live blocks."""
    rng = np.random.default_rng(13)
    x = rng.integers(-127, 128, (1, 16, 16, 512)).astype(np.int8)
    x[..., 36 * 8:] = 0
    w = rng.integers(-127, 128, (3, 3, 512, 512)).astype(np.int8)
    x, w = torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)
    ids = torch.arange(64, dtype=torch.int32, device=dev)[None].contiguous()
    cnt = torch.tensor([36], dtype=torch.int32, device=dev)
    sx = torch.tensor([3.1e-3], device=dev)
    sw = torch.rand(512, device=dev) * 1e-2 + 1e-4
    got = ecr_conv_int8_batch(x, w, sx, sw, ids, cnt, stride=1, block_c=8)
    torch.cuda.synchronize()
    want = ecr_conv_int8_plain(x, w, sx, sw, ids, cnt, stride=1, block_c=8)
    assert torch.equal(got, want)
    assert float(want.abs().max()) > 0


def test_ecr_int8_extremes_stay_exact(dev):
    args, bc = _packed_int8(dev, 2, 512, 16, 64, 3, 1, seed=0, extreme=True)
    x, w, _, _, ids, cnt = args
    ones_n, ones_o = torch.ones(2, device=dev), torch.ones(64, device=dev)
    got = ecr_conv_int8_batch(x, w, ones_n, ones_o, ids, cnt, stride=1, block_c=bc)
    assert torch.all(got[0] == -float(127 * 127 * 512 * 9))
    assert torch.all(got[1] == 0)


# (layout, b, kv, g, sq, sk, d, causal, q_offset, kv_len): the served
# qwen3-0.6b prefill and decode shapes (read from a layer slice of a stacked
# cache) and its trained forward, ragged Sq/Sk, q_offset > 0, kv_len < Sk,
# Sq = 1, a fully masked block (kv_len = 0), G = 3 and 4, head dims 8 to 256.
FLASH_CASES = [
    ("model", 4, 8, 2, 32, 64, 128, True, 0, 32),
    ("model", 4, 8, 2, 1, 64, 128, True, 40, 41),
    ("model", 8, 8, 2, 128, 128, 128, True, 0, None),
    ("kernel", 3, 1, 3, 37, 53, 64, False, 0, None),
    ("kernel", 3, 1, 3, 37, 53, 64, True, 16, None),
    ("kernel", 2, 1, 1, 100, 300, 32, True, 200, 290),
    ("kernel", 2, 1, 4, 1, 128, 32, True, 99, 100),
    ("kernel", 2, 1, 2, 8, 32, 16, False, 0, 0),
    ("kernel", 1, 1, 4, 16, 16, 8, True, 0, None),
    ("model", 2, 2, 2, 5, 70, 256, True, 65, None),
]


def _flash_operands(dev, layout, b, kv, g, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    if layout == "kernel":
        q = rng.standard_normal((b * kv, g, sq, d)).astype(np.float32)
        k = rng.standard_normal((b * kv, sk, d)).astype(np.float32)
        v = rng.standard_normal((b * kv, sk, d)).astype(np.float32)
        return tuple(torch.from_numpy(x).to(dev) for x in (q, k, v))
    q = torch.from_numpy(rng.standard_normal((b, sq, kv, g, d)).astype(np.float32)).to(dev)
    cache = torch.from_numpy(rng.standard_normal((2, 3, b, sk, kv, d)).astype(np.float32)).to(dev)
    return q, cache[0, 1], cache[1, 1]  # layer 1 of a stacked cache, in place


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_kernel_matches_plain(dev, case):
    layout, b, kv, g, sq, sk, d, causal, q_offset, kv_len = case
    q, k, v = _flash_operands(dev, layout, b, kv, g, sq, sk, d, seed=sq + sk + d)
    kw = dict(scale=d ** -0.5, causal=causal, q_offset=q_offset, kv_len=kv_len)
    before = flash_fwd.launches
    out, m, l = flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_fwd.launches == before + 1
    po, pm, pl = flash_fwd_plain(q, k, v, **kw)
    assert out.shape == q.shape and m.shape == pm.shape
    for got, want in ((out, po), (m, pm), (l, pl)):
        _close(got, want)


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_q8_kernel_matches_plain(dev, case):
    layout, b, kv, g, sq, sk, d, causal, q_offset, kv_len = case
    q, k, v = _flash_operands(dev, layout, b, kv, g, sq, sk, d, seed=sq + sk + d + 1)
    if layout == "kernel":  # per-position scales (BKV, Sk) from a 1-head view
        kq, ks = (t[:, :, 0] for t in _quantize_kv(k[:, :, None]))
        vq, vs = (t[:, :, 0] for t in _quantize_kv(v[:, :, None]))
    else:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
    kw = dict(scale=d ** -0.5, causal=causal, q_offset=q_offset, kv_len=kv_len)
    before = flash_fwd_q8.launches
    out = flash_fwd_q8(q, kq, vq, ks, vs, **kw)
    torch.cuda.synchronize()
    assert flash_fwd_q8.launches == before + 1
    _close(out, flash_fwd_q8_plain(q, kq, vq, ks, vs, **kw))


def _run_flash(q, k, v, kw):
    """fp32 flash kernel vs plain within the fp32 limit on out, m and l, one
    launch counted."""
    before = flash_fwd.launches
    got = flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_fwd.launches == before + 1
    for g_, w_ in zip(got, flash_fwd_plain(q, k, v, **kw)):
        assert g_.shape == w_.shape
        _close(g_, w_)
    return got


@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("kv_len", [1, 63, 65])
def test_flash_kernel_decode_tile_edges(dev, g, kv_len):
    """Decode (Sq = 1) at the tensor-core kernel's edges: G of a 16-row tile
    live, kv_len at one key, one short of and one past a 64-key cache read in
    place (Sk = 80), q_offset = kv_len - 1."""
    q, k, v = _flash_operands(dev, "model", 4, 8, g, 1, 80, 128, seed=g * 100 + kv_len)
    _run_flash(q, k, v, dict(scale=128 ** -0.5, causal=True, q_offset=kv_len - 1,
                             kv_len=kv_len))


def test_flash_kernel_wide_magnitudes(dev):
    """q and k spread over 2^+-3 at D = 128 (scores up to about 70), the
    served prefill shape: split-TF32 holds the limit where one TF32 product
    per multiply-add misses it (test_torch_kernels.py's host emulation)."""
    rng = np.random.default_rng(7)
    q, k, v = _flash_operands(dev, "model", 4, 8, 2, 32, 64, 128, seed=8)
    q = q * torch.from_numpy(np.exp2(rng.integers(-3, 4, tuple(q.shape))).astype(np.float32)).to(dev)
    k = k * torch.from_numpy(np.exp2(rng.integers(-3, 4, tuple(k.shape))).astype(np.float32)).to(dev)
    _run_flash(q, k, v, dict(scale=128 ** -0.5, causal=True, q_offset=0, kv_len=32))


def test_flash_kernels_launch_twice_on_one_device(dev):
    """The dynamic shared-memory limit is raised once per device and kernel:
    a second launch of each forward on the same device runs and repeats the
    first bitwise."""
    q, k, v = _flash_operands(dev, "model", 2, 2, 2, 9, 40, 128, seed=11)
    kw = dict(scale=128 ** -0.5, causal=True, q_offset=3, kv_len=None)
    first = _run_flash(q, k, v, kw)
    second = _run_flash(q, k, v, kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    kq, ks = _quantize_kv(k)
    vq, vs = _quantize_kv(v)
    before = flash_fwd_q8.launches
    o1 = flash_fwd_q8(q, kq, vq, ks, vs, **kw)
    o2 = flash_fwd_q8(q, kq, vq, ks, vs, **kw)
    torch.cuda.synchronize()
    assert flash_fwd_q8.launches == before + 2
    assert torch.equal(o1, o2)


# the flash backward: (layout, b, kv, g, sq, sk, d, causal, q_offset, kv_len)
# — every head dim the kernels take, ragged Sq / Sk, G = 1, 2, 3, 8,
# q_offset / kv_len, non-causal, a partly masked first tile (q_offset < 0
# rows see nothing: the exact-skip guard), and the trained qwen3 layer shape;
# then D = 256 in the kernel layout (the dk/dv pass's two sweeps over the
# head dim) and G = 64 in both layouts.
FLASH_BWD_CASES = [
    ("model", 2, 8, 2, 128, 128, 128, True, 0, None),
    ("kernel", 3, 1, 1, 37, 53, 8, True, 0, None),
    ("kernel", 3, 1, 2, 37, 53, 16, False, 0, None),
    ("kernel", 2, 1, 8, 70, 130, 32, True, 16, None),
    ("kernel", 2, 1, 3, 100, 300, 64, True, 200, 290),
    ("model", 2, 2, 2, 65, 97, 256, True, 32, None),
    ("model", 1, 2, 8, 33, 33, 256, False, 0, 20),
    ("kernel", 2, 1, 2, 8, 32, 128, False, 0, 0),
    ("kernel", 2, 1, 2, 40, 40, 128, True, -8, None),
    ("kernel", 2, 1, 2, 45, 77, 256, True, 0, None),
    ("kernel", 1, 1, 64, 5, 40, 64, True, 35, None),
    ("model", 1, 2, 64, 9, 50, 128, False, 0, 30),
]


@pytest.mark.parametrize("case", FLASH_BWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_bwd_kernels_match_plain(dev, case):
    from repro_torch.kernels.flash_attention.kernel import (
        flash_bwd,
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_bwd_plain,
    )

    layout, b, kv, g, sq, sk, d, causal, q_offset, kv_len = case
    q, k, v = _flash_operands(dev, layout, b, kv, g, sq, sk, d, seed=sq + sk + d + 2)
    kw = dict(scale=d ** -0.5, causal=causal, q_offset=q_offset, kv_len=kv_len)
    out, m, l = flash_fwd(q, k, v, **kw)
    do = torch.from_numpy(np.random.default_rng(d).standard_normal(tuple(q.shape))
                          .astype(np.float32)).to(dev)
    before = (flash_bwd.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches)
    got = flash_bwd(q, k, v, out, m, l, do, **kw)
    torch.cuda.synchronize()
    assert (flash_bwd.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches) == \
        tuple(n + 1 for n in before)
    want = flash_bwd_plain(q, k, v, out, m, l, do, **kw)
    for gt, wt, ref in zip(got, want, (q, k, v)):
        assert gt.shape == ref.shape
        _close(gt, wt)


def _run_flash_bwd(q, k, v, kw, seed):
    """Both backward kernels against the plain version within the fp32 limit
    on dq, dk and dv (one launch of each counted) -> (dq, dk, dv)."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_bwd_dkv,
        flash_bwd_dkv_plain,
        flash_bwd_dq,
        flash_bwd_dq_plain,
        flash_delta,
    )

    out, m, l = flash_fwd(q, k, v, **kw)
    do = torch.from_numpy(np.random.default_rng(seed).standard_normal(tuple(q.shape))
                          .astype(np.float32)).to(q.device)
    ops = (q, k, v, do, m, l, flash_delta(do, out))
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    dq = flash_bwd_dq(*ops, **kw)
    dk, dv = flash_bwd_dkv(*ops, **kw)
    torch.cuda.synchronize()
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == tuple(n + 1 for n in before)
    _close(dq, flash_bwd_dq_plain(*ops, **kw))
    for got, want in zip((dk, dv), flash_bwd_dkv_plain(*ops, **kw)):
        _close(got, want)
    return dq, dk, dv, ops


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_kernels_wide_magnitudes(dev, causal):
    """q and k spread over 2^+-3 at D = 128 over 512 keys (scores up to about
    70): split-TF32 holds the limit on dq, dk and dv where one TF32 product
    in any of the five products misses it (test_torch_kernels.py's host
    emulation)."""
    rng = np.random.default_rng(12)
    q, k, v = _flash_operands(dev, "model", 2, 4, 2, 384, 512, 128, seed=13)
    q = q * torch.from_numpy(np.exp2(rng.integers(-3, 4, tuple(q.shape))).astype(np.float32)).to(dev)
    k = k * torch.from_numpy(np.exp2(rng.integers(-3, 4, tuple(k.shape))).astype(np.float32)).to(dev)
    _run_flash_bwd(q, k, v, dict(scale=128 ** -0.5, causal=causal, q_offset=128, kv_len=None),
                   seed=14)


def test_flash_bwd_kernels_repeat_bitwise(dev):
    """Each key tile of dk/dv has one owner and every partial sum a fixed
    order (no atomics), so a second launch of each pass on the same inputs
    repeats the first bitwise; it also runs on the shared-memory limit raised
    once per device."""
    from repro_torch.kernels.flash_attention.kernel import flash_bwd_dkv, flash_bwd_dq

    q, k, v = _flash_operands(dev, "model", 2, 8, 2, 128, 128, 128, seed=15)
    kw = dict(scale=128 ** -0.5, causal=True, q_offset=0, kv_len=None)
    dq, dk, dv, ops = _run_flash_bwd(q, k, v, kw, seed=16)
    dk2, dv2 = flash_bwd_dkv(*ops, **kw)
    assert torch.equal(flash_bwd_dq(*ops, **kw), dq)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)


def test_flash_function_grads_on_the_card(dev):
    """`FlashAttentionFn` carries gradients on the card: the same q, k, v and
    output gradient give the host's plain-path gradients."""
    from repro_torch.kernels.flash_attention.ops import flash_mha

    rng = np.random.default_rng(3)
    shapes = ((2, 48, 2, 4, 64), (2, 48, 2, 64), (2, 48, 2, 64))
    host = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    w = torch.from_numpy(rng.standard_normal(shapes[0]).astype(np.float32))
    grads = []
    for device in ("cpu", dev):
        ts = [t.clone().to(device).requires_grad_(True) for t in host]
        out = flash_mha(*ts, causal=True)
        (out * w.to(device)).sum().backward()
        grads.append([t.grad.cpu() for t in ts])
    for gc, gh in zip(grads[1], grads[0]):
        assert bool(gc.abs().max() > 0)
        _close(gc, gh)


def test_flash_forward_kernel_refuses_to_drop_the_graph(dev):
    """The CUDA forward records no autograd graph: called on tensors that
    need gradients it raises, rather than return an out cut off from them;
    `FlashAttentionFn` (flash_mha) is the differentiable entry."""
    q, k, v = _flash_operands(dev, "model", 1, 2, 2, 8, 8, 16, seed=1)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="FlashAttentionFn"):
        flash_fwd(q, k, v, scale=0.25, causal=True)
    with torch.no_grad():
        flash_fwd(q, k, v, scale=0.25, causal=True)
