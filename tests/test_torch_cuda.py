"""The CUDA kernels against their plain PyTorch versions on the card. These
tests need an NVIDIA GPU and nvcc; without a card they skip (the check runs
inside the fixture, never at import). Run them on the card with
`python -m pytest -m cuda tests/test_torch_cuda.py`.

Tolerance: max|kernel - plain| <= 1e-4 * max|plain| + 1e-5 — fp32 sums in
another order (the kernel per channel then per tap, the plain version one
matmul per tap over every scheduled channel)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.conv_pool.kernel import conv_pool_batch, conv_pool_plain  # noqa: E402
from repro_torch.kernels.conv_pool.ops import conv_pool_launch  # noqa: E402
from repro_torch.kernels.ecr_conv.kernel import ecr_conv_batch, ecr_conv_plain  # noqa: E402
from repro_torch.kernels.ecr_conv.ops import ecr_conv_launch, pack_operands  # noqa: E402

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
    assert err <= 1e-4 * float(want.abs().max()) + 1e-5, err


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
