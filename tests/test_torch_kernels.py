"""Parity of the port's ECR and PECR ops, and of the kernels' plain PyTorch
versions, with the JAX package's Pallas kernels (run in interpret mode, as
the JAX package's own tests run them).

Tolerance rtol=1e-5, atol=1e-5: both sides accumulate in fp32, in another
order (the Pallas kernel sums per channel block then per tap; the plain
version gathers every scheduled block and sums per tap)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.conv_pool.kernel import conv_pool_pallas_batch  # noqa: E402
from repro.kernels.conv_pool.ops import fused_conv_pool as j_fused_conv_pool  # noqa: E402
from repro.kernels.ecr_conv.kernel import ecr_conv_pallas_batch  # noqa: E402
from repro.kernels.ecr_conv.ops import ecr_conv as j_ecr_conv  # noqa: E402
from repro_torch.kernels.conv_pool.kernel import conv_pool_batch, conv_pool_plain  # noqa: E402
from repro_torch.kernels.conv_pool.ops import fused_conv_pool  # noqa: E402
from repro_torch.kernels.conv_pool.ref import conv_pool_ref  # noqa: E402
from repro_torch.kernels.ecr_conv.kernel import ecr_conv_batch, ecr_conv_plain  # noqa: E402
from repro_torch.kernels.ecr_conv.ops import ecr_conv  # noqa: E402
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
