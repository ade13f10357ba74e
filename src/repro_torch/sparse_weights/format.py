"""BSR weight format: the block geometry shared by pruning, planning and the
conv lowering (counterpart of `repro.sparse_weights.format`).

A conv weight (O, C, kh, kw) is viewed as the GEMM operand W:(O, K),
K = C*kh*kw, cut into (bt, bf) blocks by `weight_block`: the pruner zeros
whole blocks of it, `conv2d_bsr` hands it to the BSR kernel as the sparse
left operand, and the density (the fraction of blocks holding any nonzero)
is what the planner's BSR arm prices.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _pow2_le(n: int) -> int:
    """Largest power of two <= n (n >= 1)."""
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def weight_block(o: int, k_taps: int) -> tuple:
    """(bt, bf) BSR block of an (O, K) weight matrix: bt = 8 rows, bf capped
    at 128 and shrunk on small layers so a row-block spans >= ~4 K-blocks."""
    del o
    bf = max(8, min(128, _pow2_le(max(8, k_taps // 4))))
    return 8, bf


def conv_weight_matrix(w: torch.Tensor) -> torch.Tensor:
    """(O, C, kh, kw) -> the (O, K) GEMM view, taps in (c, kh, kw) order."""
    return w.reshape(w.shape[0], -1)


def block_norms(m: torch.Tensor, block: tuple) -> torch.Tensor:
    """(n_row_blocks, n_col_blocks) L2 norms of the (bt, bf) blocks of a 2-D
    matrix (zero-padded to block multiples)."""
    bt, bf = block
    r, c = m.shape
    mp = F.pad(m, (0, (-c) % bf, 0, (-r) % bt))
    nr, nc = mp.shape[0] // bt, mp.shape[1] // bf
    return torch.sqrt((mp.reshape(nr, bt, nc, bf) ** 2).sum(dim=(1, 3)))


def matrix_block_density(m: torch.Tensor, block: tuple) -> float:
    """Fraction of (bt, bf) blocks of a 2-D matrix with any nonzero entry."""
    norms = block_norms(m, block)
    return float((norms > 0).sum()) / max(norms.numel(), 1)


def weight_block_density(w: torch.Tensor) -> float:
    """Achieved block density of a conv weight (O, C, kh, kw), or of a dense
    weight (d_in, d_out) on its (d_out, d_in) orientation. 1.0 when unpruned."""
    if w.ndim == 4:
        m = conv_weight_matrix(w)
    elif w.ndim == 2:
        m = w.T
    else:
        raise ValueError(f"weight_block_density expects a conv (O,C,kh,kw) or "
                         f"dense (d_in,d_out) weight, got shape {tuple(w.shape)}")
    return matrix_block_density(m, weight_block(m.shape[0], m.shape[1]))
