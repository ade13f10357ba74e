"""`channel_block_occupancy` (`kernels/ecr_conv/ops.py`) against the JAX
package's on the same numpy maps: the live share of channel blocks at the
block size `ecr_conv` resolves, a non-dividing block_c included, before and
after channel compaction; and against the port's planner statistics
(`occupancy_stat`, `measure_occupancy`) on the same maps. Mirrors
`tests/test_tiles.py::test_channel_block_occupancy_matches_executed_schedule`,
`tests/test_kernels.py::test_channel_block_occupancy` and
`tests/test_serving.py::test_measure_occupancy_batch1_equals_single_image_compacted`.
Every value is a ratio of small integers, computed in fp32 on both sides:
equal, not close."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.sparsity import synth_feature_map  # noqa: E402
from repro.kernels.ecr_conv.ops import channel_block_occupancy as j_occupancy  # noqa: E402
from repro_torch.kernels.ecr_conv.ops import channel_block_occupancy  # noqa: E402
from repro_torch.kernels.tiles import TileConfig, resolve_conv_tile  # noqa: E402
from repro_torch.pipeline.planner import measure_occupancy, occupancy_stat  # noqa: E402


def _map(shape, sparsity, seed, dead_from=None):
    x = np.array(synth_feature_map(jax.random.PRNGKey(seed), shape, sparsity), np.float32)
    if dead_from is not None:
        x[dead_from:] = 0.0
    return x


@pytest.mark.parametrize("block_c", [8, 12, 16, 128])
def test_matches_the_executed_schedule_and_jax(block_c):
    """16 channels, 5 live: compacted, ceil(5 / bc) / ceil(16 / bc) at the
    resolved bc (12 stays 12: two blocks, the second padded), equal to the
    JAX package's and to the planner's `occupancy_stat`."""
    c, h, w = 16, 10, 10
    x = _map((c, h, w), 0.0, seed=9, dead_from=5)
    bc = resolve_conv_tile(h, w, c, c, TileConfig(block_c=block_c))[0]
    expect = math.ceil(5 / bc) / math.ceil(c / bc)
    got = channel_block_occupancy(torch.from_numpy(x), block_c=block_c, compact=True)
    assert got == expect == j_occupancy(jnp.asarray(x), block_c=block_c, compact=True)
    assert float(occupancy_stat(torch.from_numpy(x)[None], block_c)) == pytest.approx(expect)
    if block_c == 12:
        assert bc == 12 and expect == 0.5


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("block_c", [4, 8, 12, 16, 128])
@pytest.mark.parametrize("case", [((16, 8, 8), 0.3, 0, 8), ((16, 8, 8), 0.6, 1, None),
                                  ((24, 7, 9), 0.5, 2, 13), ((40, 6, 6), 0.9, 3, 30)],
                         ids=lambda c: f"{c[0][0]}x{c[0][1]}x{c[0][2]}-s{c[1]}")
def test_matches_jax(case, block_c, compact):
    """Same numpy map, same value, with and without compaction, dividing and
    non-dividing block sizes (the tail block padded), dead channel runs that
    do and do not line up with the blocks."""
    shape, sparsity, seed, dead = case
    x = _map(shape, sparsity, seed, dead_from=dead)
    if dead is None:
        x[::3] = 0.0  # scattered dead channels
    want = j_occupancy(jnp.asarray(x), block_c=block_c, compact=compact)
    got = channel_block_occupancy(torch.from_numpy(x), block_c=block_c, compact=compact)
    assert got == want and isinstance(got, float)


def test_half_the_blocks_dead():
    """`tests/test_kernels.py`'s case: 16 channels, the first 8 dead, block_c 8."""
    x = _map((16, 8, 8), 0.3, seed=0, dead_from=None)
    x[0:8] = 0
    assert channel_block_occupancy(torch.from_numpy(x), block_c=8) == 0.5 == \
        j_occupancy(jnp.asarray(x), block_c=8)


@pytest.mark.parametrize("seed,dead", [(0, 5), (1, 11), (2, 0)])
def test_measure_occupancy_at_batch_1_is_the_compacted_single_image(seed, dead):
    """The port's `measure_occupancy` at batch 1 equals the single-image
    compacted occupancy, ceil(n_live / bc) / n_blocks, and the JAX value."""
    x = np.array(jax.random.uniform(jax.random.PRNGKey(seed), (16, 9, 9)), np.float32)
    if dead:
        x[16 - dead:] = 0.0
    single = channel_block_occupancy(torch.from_numpy(x), 8, compact=True)
    assert measure_occupancy(torch.from_numpy(x)[None], block_c=8) == pytest.approx(single)
    assert single == j_occupancy(jnp.asarray(x), 8, compact=True)
