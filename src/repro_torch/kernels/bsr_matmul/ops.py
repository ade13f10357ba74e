"""Block-sparse matmul op: the block-granularity ECR schedule of the sparse
left operand, and the kernel launch (counterpart of
`repro.kernels.bsr_matmul.ops`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.sparsity import block_occupancy, compact_block_ids
from repro_torch.kernels.bsr_matmul.kernel import bsr_matmul
from repro_torch.kernels.schedule_guard import guard_schedule


def _pad_to_blocks(h: torch.Tensor, bt: int, bf: int) -> torch.Tensor:
    t, f = h.shape
    return F.pad(h, (0, (-f) % bf, 0, (-t) % bt))


def block_schedule(h: torch.Tensor, bt: int, bf: int):
    """(ids, cnt): the block-granularity ECR compression of h's (bt, bf)
    blocks, per row-block (live blocks first, in order, padded with the
    first id). A ragged h is zero-padded to block multiples first, which
    leaves every real block's occupancy as it is."""
    return compact_block_ids(block_occupancy(_pad_to_blocks(h, bt, bf), (bt, bf)))


def sparse_matmul(h: torch.Tensor, w: torch.Tensor, block: tuple = (8, 128),
                  tile=None):
    """y = h @ w skipping all-zero block = (bt, bf) blocks of h. `tile` (a
    `TileConfig`) overrides bf by the reference's rule (honoured iff
    0 < bf <= max(8, F)); the CUDA kernel's row block is fixed, so the
    tile's bt is not taken, and the reference's column block has no
    counterpart (the kernel tiles the columns on its own)."""
    bt, bf = block
    if tile is not None and 0 < tile.bf <= max(8, h.shape[1]):
        bf = tile.bf
    ids, cnt = block_schedule(h, bt, bf)
    ids, cnt = guard_schedule(ids, cnt, -(-h.shape[1] // bf))
    return bsr_matmul(h, w, ids, cnt, block=(bt, bf))


def schedule_occupancy(h: torch.Tensor, bt: int = 8, bf: int = 128) -> float:
    """Fraction of blocks that are live (== fraction of MACs not skipped)."""
    occ = block_occupancy(_pad_to_blocks(h, bt, bf), (bt, bf))
    return float(occ.float().mean())
