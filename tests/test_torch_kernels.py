"""Parity of the port's ECR and PECR ops, and of the kernels' plain PyTorch
versions (ECR, PECR, BSR), with the JAX package's Pallas kernels (run in
interpret mode, as the JAX package's own tests run them), and the host
emulation of split-TF32, the arithmetic of the fp32 tensor-core kernels.

Tolerance rtol=1e-5, atol=1e-5: both sides accumulate in fp32, in another
order (the Pallas kernel sums per channel block then per tap; the plain
version gathers every scheduled block and sums per tap); BSR atol
1e-5 * max|Pallas| (the Pallas kernel sums block by block, the plain
version in one matmul)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.bsr_matmul.kernel import bsr_matmul_pallas  # noqa: E402
from repro.kernels.conv_pool.kernel import conv_pool_pallas_batch  # noqa: E402
from repro.kernels.conv_pool.ops import fused_conv_pool as j_fused_conv_pool  # noqa: E402
from repro.kernels.ecr_conv.kernel import ecr_conv_pallas_batch  # noqa: E402
from repro.kernels.ecr_conv.ops import ecr_conv as j_ecr_conv  # noqa: E402
from repro_torch.core.sparsity import patches_t  # noqa: E402
from repro_torch.kernels.bsr_matmul.kernel import (  # noqa: E402
    bsr_matmul_plain,
    scheduled_operand,
)
from repro_torch.kernels.bsr_matmul.ops import block_schedule  # noqa: E402
from repro_torch.kernels.conv_pool.kernel import conv_pool_batch, conv_pool_plain  # noqa: E402
from repro_torch.kernels.conv_pool.ops import fused_conv_pool  # noqa: E402
from repro_torch.kernels.conv_pool.ref import conv_pool_ref  # noqa: E402
from repro_torch.kernels.ecr_conv.kernel import (  # noqa: E402
    ecr_conv_batch,
    ecr_conv_plain,
    scheduled_conv_sum,
)
from repro_torch.kernels.ecr_conv.ops import ecr_conv  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_bwd_plain,
    flash_delta,
    flash_fwd_plain,
)
from repro_torch.kernels.ecr_conv.ref import ecr_conv_ref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, n=4, c=12, hw=14, o=8, k=3):
    """Post-ReLU-like batch with a shared dead-channel band, per-sample dead
    channels, and a trailing all-zero sample (a batcher pad)."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, c, hw, hw), dtype=np.float32)
    x[:, c - c // 3:] = 0.0
    x *= rng.random((n, c, 1, 1)) > 0.3
    x[-1] = 0.0
    w = rng.standard_normal((o, c, k, k)).astype(np.float32) / (c * k * k) ** 0.5
    return x, w


@pytest.mark.parametrize("stride,k,block_c", [(1, 3, 8), (2, 5, 8), (4, 5, 4), (1, 3, 0)])
def test_ecr_conv_matches_jax(stride, k, block_c):
    x, w = _inputs(10 + stride + k, k=k)
    want = np.asarray(j_ecr_conv(jnp.asarray(x), jnp.asarray(w), stride,
                                 block_c=block_c))
    got = ecr_conv(torch.from_numpy(x), torch.from_numpy(w), stride,
                   block_c=block_c).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # the dense oracle agrees too (ECR skips only zero work)
    np.testing.assert_allclose(
        got, ecr_conv_ref(torch.from_numpy(x), torch.from_numpy(w), stride).numpy(), **TOL)


@pytest.mark.parametrize("stride,k", [(1, 3), (2, 5)])
def test_ecr_conv_single_image_matches_jax(stride, k):
    """The op's 3-D branch: identity-prefix schedule, kernel run at N=1."""
    x, w = _inputs(20 + stride, k=k)
    want = np.asarray(j_ecr_conv(jnp.asarray(x[0]), jnp.asarray(w), stride, block_c=8))
    got = ecr_conv(torch.from_numpy(x[0]), torch.from_numpy(w), stride, block_c=8).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("stride,k,hw", [(1, 3, 14), (1, 5, 14), (2, 3, 14)])
def test_fused_conv_pool_matches_jax(stride, k, hw):
    x, w = _inputs(30 + k + stride, k=k, hw=hw)
    want = np.asarray(j_fused_conv_pool(jnp.asarray(x), jnp.asarray(w), stride, 2,
                                        block_c=8))
    got = fused_conv_pool(torch.from_numpy(x), torch.from_numpy(w), stride, 2,
                          block_c=8).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        got, conv_pool_ref(torch.from_numpy(x), torch.from_numpy(w), stride, 2).numpy(),
        **TOL)
    assert np.all(got[-1] == 0.0)  # the all-zero pad sample pools to zeros


def test_fused_conv_pool_single_image_matches_jax():
    x, w = _inputs(40)
    want = np.asarray(j_fused_conv_pool(jnp.asarray(x[1]), jnp.asarray(w), 1, 2, block_c=8))
    got = fused_conv_pool(torch.from_numpy(x[1]), torch.from_numpy(w), 1, 2, block_c=8).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _dropped_schedule(x_nhwc, bc):
    """A hand-built schedule that leaves out one LIVE block of sample 0 and
    gives the last sample cnt = 0; both kernels must drop exactly that work."""
    n, _, _, c = x_nhwc.shape
    n_cb = c // bc
    ids = np.tile(np.arange(n_cb, dtype=np.int32), (n, 1))
    cnt = np.full((n,), n_cb, np.int32)
    live0 = [j for j in range(n_cb) if np.any(x_nhwc[0, :, :, j * bc:(j + 1) * bc])]
    assert len(live0) >= 2
    drop = live0[0]
    ids[0] = [j for j in range(n_cb) if j != drop] + [0]
    cnt[0] = n_cb - 1
    cnt[-1] = 0
    return ids, cnt


@pytest.mark.parametrize("pool", [0, 2])
def test_plain_version_drops_what_the_pallas_kernel_drops(pool):
    """Plain version vs the Pallas kernel called directly with the same
    packed operands and a schedule missing a live block."""
    rng = np.random.default_rng(50 + pool)
    n, h, c, o, bc, k = 3, 10, 16, 8, 4, 3
    x = rng.random((n, h, h, c), dtype=np.float32)
    w = rng.standard_normal((k, k, c, o)).astype(np.float32)
    ids, cnt = _dropped_schedule(x, bc)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    tids, tcnt = torch.from_numpy(ids), torch.from_numpy(cnt)
    if pool:
        want = np.asarray(conv_pool_pallas_batch(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(ids), jnp.asarray(cnt),
            stride=1, pool=pool, block_c=bc, block_o=o))
        got = conv_pool_plain(tx, tw, tids, tcnt, stride=1, pool=pool, block_c=bc)
        assert np.array_equal(conv_pool_batch(tx, tw, tids, tcnt, stride=1, pool=pool,
                                              block_c=bc).numpy(), got.numpy())
    else:
        want = np.asarray(ecr_conv_pallas_batch(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(ids), jnp.asarray(cnt),
            stride=1, block_c=bc, block_o=o))
        got = ecr_conv_plain(tx, tw, tids, tcnt, stride=1, block_c=bc)
        assert np.array_equal(ecr_conv_batch(tx, tw, tids, tcnt, stride=1,
                                             block_c=bc).numpy(), got.numpy())
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the dropped block really mattered: the full schedule differs
    full = ecr_conv_plain(tx, tw, torch.from_numpy(np.tile(np.arange(c // bc, dtype=np.int32), (n, 1))),
                          torch.full((n,), c // bc, dtype=torch.int32), stride=1, block_c=bc,
                          pool=pool)
    assert not np.allclose(full[0].numpy(), got[0].numpy(), **TOL)
    assert np.all(got[-1].numpy() == 0.0)


def test_cpu_wrapper_does_not_count_launches():
    """Only a CUDA launch counts; the plain version on the host does not."""
    x, w = _inputs(60)
    before = (ecr_conv_batch.launches, conv_pool_batch.launches)
    ecr_conv(torch.from_numpy(x), torch.from_numpy(w), 1, block_c=8)
    fused_conv_pool(torch.from_numpy(x), torch.from_numpy(w), 1, 2, block_c=8)
    assert (ecr_conv_batch.launches, conv_pool_batch.launches) == before


def test_wrapper_rejects_bad_operands():
    x = torch.zeros(2, 6, 6, 12)
    w = torch.zeros(3, 3, 12, 4)
    ids = torch.zeros(2, 3, dtype=torch.int32)
    cnt = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of block_c"):
        ecr_conv_batch(x, w, ids, cnt, stride=1, block_c=5)
    with pytest.raises(ValueError, match="schedule shapes"):
        ecr_conv_batch(x, w, ids[:, :2], cnt, stride=1, block_c=4)
    with pytest.raises(ValueError, match="pool window"):
        conv_pool_batch(x, w, ids, cnt, stride=1, pool=0, block_c=4)


# The split-TF32 kernel's k-steps are 8 channels: block_c 4 packs two
# scheduled blocks into a step (an odd cnt leaves half a step, zero-filled),
# block_c 16 takes two steps per block, block_c 8 one; (bc, n_cb, cnt, map
# (h, w), pool).
SCHEDULE_TAILS = [
    (4, 6, [1, 2, 3, 6, 0, 5], (7, 6), 0),
    (8, 4, [1, 2, 3, 4, 0], (9, 9), 2),
    (16, 2, [1, 2, 0], (8, 7), 0),
    (4, 4, [3, 0, 1, 4], (9, 11), 2),
    (16, 2, [2, 1, 0], (10, 9), 2),
]


@pytest.mark.parametrize("bc,n_cb,cnts,hw,pool", SCHEDULE_TAILS)
def test_plain_matches_pallas_at_schedule_tails(bc, n_cb, cnts, hw, pool):
    """Plain version vs the Pallas kernel (interpret mode) on the same packed
    operands: schedule tails, permuted ids, cnt = 0, block_c 4/8/16, odd maps
    with a floor pool."""
    rng = np.random.default_rng(bc * 100 + sum(cnts))
    n, (h, w_), c, o = len(cnts), hw, n_cb * bc, 8
    x = rng.random((n, h, w_, c), dtype=np.float32)
    w = rng.standard_normal((3, 3, c, o)).astype(np.float32)
    ids = np.stack([rng.permutation(n_cb) for _ in cnts]).astype(np.int32)
    cnt = np.asarray(cnts, np.int32)
    jargs = tuple(map(jnp.asarray, (x, w, ids, cnt)))
    targs = tuple(map(torch.from_numpy, (x, w, ids, cnt)))
    if pool:
        want = conv_pool_pallas_batch(*jargs, stride=1, pool=pool, block_c=bc, block_o=o)
        got = conv_pool_plain(*targs, stride=1, pool=pool, block_c=bc)
        assert got.shape == (n, (h - 2) // pool, (w_ - 2) // pool, o)
    else:
        want = ecr_conv_pallas_batch(*jargs, stride=1, block_c=bc, block_o=o)
        got = ecr_conv_plain(*targs, stride=1, block_c=bc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(np.abs(np.asarray(want)).max()) > 0.0
    assert float(got[cnts.index(0)].abs().max()) == 0.0


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the host: keep 10 mantissa bits, rounding to
    nearest with ties away from zero (add half an ulp of TF32 to the
    magnitude bits, then clear the 13 low bits)."""
    return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(t: torch.Tensor):
    """`split` of tf32_mma.cuh on the host, as the tensor cores see it:
    hi = a rounded to TF32 (to nearest, ties away from zero: `_tf32`), lo =
    a - hi with its 13 low bits dropped (the MMA truncates a raw operand)."""
    hi = _tf32(t)
    return hi, ((t - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_probe_operands(kind: str, seed: int = 0):
    """A conv with VGG-19 conv10's reduction (3x3x512 = 4,608 terms) over
    16x16 = 256 positions and 64 output channels: x uniform on [0, 1) and
    w normal over sqrt(K) ("uniform"), or both scaled elementwise by 2^e,
    e uniform over -12..12 ("wide"). Returns NHWC x and (kh,kw,C,O) w."""
    rng = np.random.default_rng(seed)
    x = rng.random((1, 18, 18, 512), dtype=np.float32)
    w = (rng.standard_normal((3, 3, 512, 64)) / np.sqrt(4608)).astype(np.float32)
    if kind == "wide":
        x = (x * np.exp2(rng.integers(-12, 13, x.shape))).astype(np.float32)
        w = (w * np.exp2(rng.integers(-12, 13, w.shape))).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


def test_tf32_rounding_matches_its_definition():
    vals = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12, -(1.0 + 2.0 ** -11),
                         1.0 + 2.0 ** -11 - 2.0 ** -23, 2.0 - 2.0 ** -12, 3.5e-20])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                         1.0, 2.0, 0.0])
    got = _tf32(vals)
    assert torch.equal(got[:6], want[:6])
    assert float(abs(got[6] - vals[6]) / vals[6]) <= 2.0 ** -11
    assert torch.all(got.view(torch.int32) & 0x1FFF == 0)


@pytest.mark.parametrize("kind", ["uniform", "wide"])
def test_split_tf32_holds_the_fp32_limit_where_one_product_fails(kind):
    """The premise of the CUDA kernel's arithmetic, emulated on the host: with
    a = hi + lo as `split` forms them (`_split`), the three TF32 products
    lo*hi + hi*lo + hi*hi (each exact in fp32, summed here in float64) stay
    within the fp32 limit of the plain fp32 conv, while one TF32 product per
    multiply-add errs by more than twice the limit. The card test with the
    same operands (test_torch_cuda.py) then fails a kernel that drops the
    split."""
    x, w = tf32_probe_operands(kind)
    ids = torch.arange(64, dtype=torch.int32)[None]
    cnt = torch.tensor([64], dtype=torch.int32)
    plain = ecr_conv_plain(x, w, ids, cnt, stride=1, block_c=8)
    scale = float(plain.abs().max())
    limit = 1e-4 * scale + 1e-5 * min(1.0, scale)

    def emulated(*pairs):
        return sum(scheduled_conv_sum(a, b, ids, cnt, stride=1, block_c=8,
                                      dtype=torch.float64) for a, b in pairs).float()

    (xh, xl), (wh, wl) = _split(x), _split(w)
    one = float((emulated((xh, wh)) - plain).abs().max())
    three = float((emulated((xl, wh), (xh, wl), (xh, wh)) - plain).abs().max())
    assert one > 2 * limit, (one, limit)
    assert three < 0.05 * limit, (three, limit)


def _bsr_probe_operands(kind: str):
    """The conv probe as the BSR conv lowering sees it: W (64, 4608) and the
    patch matrix A^T (4608, 256), every (8, 128) block scheduled."""
    x, w = tf32_probe_operands(kind)
    at, _, _ = patches_t(x.permute(0, 3, 1, 2), 3, 3)
    h = w.permute(3, 2, 0, 1).reshape(64, -1).contiguous()  # (O, C*kh*kw)
    ids, cnt = block_schedule(h, 8, 128)
    return h, at.contiguous(), ids, cnt


@pytest.mark.parametrize("kind", ["uniform", "wide"])
def test_split_tf32_holds_the_fp32_limit_for_the_bsr_product(kind):
    """The BSR kernel's arithmetic (bsr_matmul.cu: `split`, lo
    truncated) emulated on the host at K = 4608: three TF32 products per
    multiply-add (exact products, summed in float64) stay within the fp32
    limit of the plain version, one TF32 product errs by more than twice the
    limit. The card tests with the same
    data (test_torch_cuda.py) then fail a kernel that drops the split."""
    h, at, ids, cnt = _bsr_probe_operands(kind)
    assert int(cnt.min()) == 36
    plain = bsr_matmul_plain(h, at, ids, cnt, block=(8, 128))
    scale = float(plain.abs().max())
    limit = 1e-4 * scale + 1e-5 * min(1.0, scale)
    hs = scheduled_operand(h, ids, cnt, (8, 128))

    def emulated(*pairs):
        return sum(a.double() @ b.double() for a, b in pairs).float()

    (hh, hl), (ah, al) = _split(hs), _split(at)
    one = float((emulated((hh, ah)) - plain).abs().max())
    three = float((emulated((hl, ah), (hh, al), (hh, ah)) - plain).abs().max())
    assert one > 2 * limit, (one, limit)
    assert three < 0.05 * limit, (three, limit)


def _pallas_bsr(h, w, ids, cnt, bf):
    """bsr_matmul_pallas (interpret mode) on h and w zero-padded to its block
    multiples, cut back to (T, D)."""
    t, f = h.shape
    d = w.shape[1]
    hp = np.pad(h, ((0, (-t) % 8), (0, (-f) % bf)))
    wp = np.pad(w, ((0, (-f) % bf), (0, (-d) % 8)))
    out = bsr_matmul_pallas(jnp.asarray(hp), jnp.asarray(wp), jnp.asarray(ids),
                            jnp.asarray(cnt), block=(8, bf, wp.shape[1]))
    return np.asarray(out)[:t, :d]


# The paths of the tensor-core BSR kernel: union schedules of 8 row-blocks
# whose ids differ (a block one row-block keeps and its neighbour leaves out,
# ids in any order), a row-block with cnt = 0, bf = 8 with F = 27 (VGG-19
# conv1_1: the last block 3 rows deep), T not a multiple of 8, a second row
# group; (t, f, d, bf).
BSR_UNION_EDGES = [(64, 27, 40, 8), (70, 200, 24, 16), (128, 1152, 16, 128),
                   (24, 25, 9, 8)]


@pytest.mark.parametrize("t,f,d,bf", BSR_UNION_EDGES)
def test_bsr_plain_matches_pallas_at_union_schedules(t, f, d, bf):
    """Plain version vs the Pallas kernel on the same operands and a
    hand-made schedule: each row-block keeps its own random subset of the
    (all live) blocks, in permuted order, row-block 1 none."""
    rng = np.random.default_rng(t + f + bf)
    nt, nf = -(-t // 8), -(-f // bf)
    h = rng.standard_normal((t, f)).astype(np.float32)
    w = rng.standard_normal((f, d)).astype(np.float32)
    ids = np.zeros((nt, nf), np.int32)
    cnt = np.zeros((nt,), np.int32)
    for i in range(nt):
        keep = rng.permutation(nf)[:0 if i == 1 else rng.integers(1, nf + 1)]
        ids[i, :len(keep)] = keep
        ids[i, len(keep):] = keep[-1] if len(keep) else 0
        cnt[i] = len(keep)
    assert len({tuple(sorted(r[:c])) for r, c in zip(ids, cnt) if c}) > 1
    want = _pallas_bsr(h, w, ids, cnt, bf)
    got = bsr_matmul_plain(*map(torch.from_numpy, (h, w, ids, cnt)), block=(8, bf))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    assert np.all(got.numpy()[8:16] == 0.0)
    assert float(np.abs(want).max()) > 0.0


def test_a_repeated_block_is_refused_where_the_reference_adds_it_twice(monkeypatch):
    """h (8, 16), w (16, 8), block (8, 8), ids [[1, 1]], cnt [2]: the Pallas
    kernel adds block 1 once per listing (twice), the port's BSR kernel and
    plain version once, so the port's schedule guard refuses the schedule."""
    from repro_torch.kernels.schedule_guard import guard_schedule

    rng = np.random.default_rng(6)
    h = rng.standard_normal((8, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    ids, cnt = np.array([[1, 1]], np.int32), np.array([2], np.int32)
    once = h[:, 8:] @ w[8:]
    np.testing.assert_allclose(_pallas_bsr(h, w, ids, cnt, 8), 2 * once, rtol=1e-5, atol=1e-5)
    got = bsr_matmul_plain(*map(torch.from_numpy, (h, w, ids, cnt)), block=(8, 8))
    np.testing.assert_allclose(got.numpy(), once, rtol=1e-5, atol=1e-5)
    monkeypatch.setenv("REPRO_CHECK_SCHEDULES", "1")
    with pytest.raises(ValueError, match="more than once"):
        guard_schedule(torch.from_numpy(ids), torch.from_numpy(cnt), 2)


def flash_probe_operands(kind: str, seed: int = 0):
    """The served qwen3-0.6b prefill shape in the kernel layout, q (32, 2, 32,
    128) over k, v (32, 64, 128): normal q, k and v ("normal"), or q and k
    scaled elementwise by 2^e, e uniform over -3..3 ("wide": scores up to
    about 70, where the plain version's own fp32 rounding of a score moves
    its exp by a few hundredths of the limit)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((32, 2, 32, 128), (32, 64, 128), (32, 64, 128)))
    if kind == "wide":
        q = (q * np.exp2(rng.integers(-3, 4, q.shape))).astype(np.float32)
        k = (k * np.exp2(rng.integers(-3, 4, k.shape))).astype(np.float32)
    return torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)


@pytest.mark.parametrize("kind", ["normal", "wide"])
def test_flash_needs_split_tf32_at_head_dim_128(kind):
    """The fp32 flash kernel's arithmetic (flash_attention.cu) emulated on the
    host at D = 128, causal with kv_len 32 over a 64-slot cache: Q.K^T and
    P.V with one TF32 product per multiply-add miss the fp32 limit on the
    scores' max m (and so on l and out), while three (split-TF32) hold it on
    out, m and l, which is why the kernel splits both products."""
    q, k, v = flash_probe_operands(kind)
    kw = dict(scale=128 ** -0.5, causal=True, q_offset=0, kv_len=32)
    want = flash_fwd_plain(q, k, v, **kw)
    qs = q * kw["scale"]
    keep = torch.arange(64)[None, :] <= torch.arange(32)[:, None]

    def emulated(prod):
        s = prod(qs, k.transpose(1, 2)[:, None])
        s = torch.where(keep, s, torch.full((), -1e30, dtype=s.dtype))
        m = s.amax(-1)
        p = torch.exp(s - m[..., None]).float()
        l = p.double().sum(-1)
        return (prod(p, v[:, None]) / l[..., None]).float(), m.float(), l.float()

    def one(a, b):
        return _tf32(a).double() @ _tf32(b).double()

    def three(a, b):
        (ah, al), (bh, bl) = _split(a), _split(b)
        return ah.double() @ bh.double() + ah.double() @ bl.double() + al.double() @ bh.double()

    def excess(got):  # err / limit per output (out, m, l)
        out = []
        for g, w in zip(got, want):
            scale = float(w.abs().max())
            out.append(float((g - w).abs().max()) / (1e-4 * scale + 1e-5 * min(1.0, scale)))
        return out

    e1, e3 = excess(emulated(one)), excess(emulated(three))
    assert e1[1] > 2.0, e1  # m: the scores with one product miss the limit
    assert max(e3) < 0.1, e3


def flash_bwd_probe_operands(kind: str, seed: int = 0):
    """The backward kernels' layout at qwen3-0.6b's head dim: q and do (8, 2,
    S, 128) over k, v (8, S, 128), normal ("normal", S = 128, the trained
    sequence), or with q and k scaled elementwise by 2^e, e uniform over
    -3..3 ("wide", S = 512)."""
    s = 128 if kind == "normal" else 512
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(sh).astype(np.float32) for sh in
                   ((8, 2, s, 128), (8, s, 128), (8, s, 128), (8, 2, s, 128)))
    if kind == "wide":
        q = (q * np.exp2(rng.integers(-3, 4, q.shape))).astype(np.float32)
        k = (k * np.exp2(rng.integers(-3, 4, k.shape))).astype(np.float32)
    return tuple(torch.from_numpy(x) for x in (q, k, v, do))


BWD_PRODUCTS = ("S", "dP", "dQ", "dK", "dV")
# the gradients each product feeds: S and dP through p and ds, the rest directly
BWD_FEEDS = {"S": (0, 1, 2), "dP": (0, 1), "dQ": (0,), "dK": (1,), "dV": (2,)}


@pytest.mark.parametrize("kind", ["normal", "wide"])
def test_flash_backward_needs_split_tf32_in_every_product(kind):
    """The fp32 flash backward kernels' arithmetic (flash_attention_bwd.cu)
    emulated on the host at D = 128, causal, against the plain version from
    the same forward m, l and delta: with three TF32 products per
    multiply-add (split-TF32) in all five products S = Q.K^T, dP = dO.V^T,
    dQ = dS.K, dK = dS^T.Q, dV = P^T.dO, dq, dk and dv stay under a third of
    the fp32 limit; with one TF32 product in any single product (the other
    four split) every gradient that product feeds misses the limit by more
    than 2x. So the kernels split all five."""
    q, k, v, do = flash_bwd_probe_operands(kind)
    s = q.shape[2]
    kw = dict(scale=128 ** -0.5, causal=True, q_offset=0, kv_len=None)
    out, m, l = flash_fwd_plain(q, k, v, **kw)
    want = flash_bwd_plain(q, k, v, out, m, l, do, **kw)
    delta = flash_delta(do, out)
    qs = q * kw["scale"]
    keep = torch.arange(s)[None, :] <= torch.arange(s)[:, None]

    def one(a, b):
        return (_tf32(a).double() @ _tf32(b).double()).float()

    def three(a, b):
        (ah, al), (bh, bl) = _split(a), _split(b)
        return (ah.double() @ bh.double() + ah.double() @ bl.double()
                + al.double() @ bh.double()).float()

    def emulated(single=None):
        prod = {name: one if name == single else three for name in BWD_PRODUCTS}
        sc = torch.where(keep, prod["S"](qs, k.transpose(1, 2)[:, None]),
                         torch.full((), -1e30))
        p = torch.exp(sc - m[..., None]) / l[..., None]
        ds = p * (prod["dP"](do, v.transpose(1, 2)[:, None]) - delta[..., None])
        return (prod["dQ"](ds, k[:, None]) * kw["scale"],
                prod["dK"](ds.transpose(2, 3), qs).sum(1),
                prod["dV"](p.transpose(2, 3), do).sum(1))

    def excess(got):  # err / limit per gradient (dq, dk, dv)
        res = []
        for g, w in zip(got, want):
            scale = float(w.abs().max())
            res.append(float((g - w).abs().max()) / (1e-4 * scale + 1e-5 * min(1.0, scale)))
        return res

    split = excess(emulated())
    assert max(split) < 1 / 3, split
    for name in BWD_PRODUCTS:
        e1 = excess(emulated(single=name))
        assert all(e1[i] > 2.0 for i in BWD_FEEDS[name]), (name, e1)
