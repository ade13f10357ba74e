"""Block-sparse matmul kernel wrapper and its plain PyTorch version.

`bsr_matmul` replaces `repro.kernels.bsr_matmul.kernel.bsr_matmul_pallas`.
On a CUDA tensor it launches the hand-written kernel in
`repro_torch/kernels/csrc/bsr_matmul.cu` (split-TF32 on the tensor cores,
fp32 accuracy) and counts the launch in `bsr_matmul.launches`; on a CPU
tensor it runs `bsr_matmul_plain`. There is no fallback from one to the
other.

Unlike the Pallas kernel, the operands need no padding to block multiples:
the schedule counts ceil(T/bt) row-blocks of ceil(F/bf) reduction blocks and
the ragged edges are masked.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cuda import check_bsr_operands, count_launch, launch_bsr


def schedule_mask(ids: torch.Tensor, cnt: torch.Tensor, nf: int) -> torch.Tensor:
    """(nt, nf) bool: block (i, j) is scheduled iff j is among
    ids[i, :cnt[i]]. Padding lanes and out-of-range ids schedule nothing
    (the kernel masks such a block's rows away too); a block listed twice
    counts once, as in the kernel (`guard_schedule` refuses such a
    schedule: the Pallas kernel would add it twice)."""
    nt = ids.shape[0]
    lane = torch.arange(nf, device=ids.device)
    ids = ids.long()
    valid = (lane[None, :] < cnt.clamp(0, nf)[:, None]) & (ids >= 0) & (ids < nf)
    hits = torch.zeros((nt, nf), dtype=torch.int32, device=ids.device)
    hits.scatter_add_(1, ids.clamp(0, nf - 1), valid.to(torch.int32))
    return hits > 0


def scheduled_operand(h: torch.Tensor, ids: torch.Tensor, cnt: torch.Tensor,
                      block: tuple) -> torch.Tensor:
    """h with every (bt, bf) block the schedule leaves out set to zero."""
    t, f = h.shape
    bt, bf = block
    keep = schedule_mask(ids, cnt, -(-f // bf))
    mask = keep.repeat_interleave(bt, 0)[:t].repeat_interleave(bf, 1)[:, :f]
    return torch.where(mask, h, torch.zeros((), dtype=h.dtype, device=h.device))


def bsr_matmul_plain(h: torch.Tensor, w: torch.Tensor, ids: torch.Tensor,
                     cnt: torch.Tensor, *, block: tuple) -> torch.Tensor:
    """The kernel's function in plain PyTorch, schedule honored: zero the
    blocks of h the schedule leaves out, then one fp32 matmul.
    h (T,F) @ w (F,D) -> (T,D)."""
    check_bsr_operands(h, w, ids, cnt, block)
    return torch.matmul(scheduled_operand(h, ids, cnt, block).float(), w.float())


def bsr_matmul(h: torch.Tensor, w: torch.Tensor, ids: torch.Tensor,
               cnt: torch.Tensor, *, block: tuple) -> torch.Tensor:
    """y = h @ w over the scheduled block = (bt, bf) blocks of h: h (T,F), w (F,D),
    ids (ceil(T/bt), ceil(F/bf)), cnt (ceil(T/bt),) -> fp32 (T,D). CUDA
    tensor: the CUDA kernel; CPU tensor: the plain version."""
    if h.device.type == "cpu":
        return bsr_matmul_plain(h, w, ids, cnt, block=block)
    if h.device.type != "cuda":
        raise ValueError(f"bsr_matmul runs on cuda or cpu, got {h.device}")
    out = launch_bsr(h, w, ids, cnt, block=block)
    count_launch(bsr_matmul)
    return out


bsr_matmul.launches = 0
