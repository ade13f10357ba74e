"""int8 ECR conv and BSR matmul kernel wrappers and their plain PyTorch
versions (counterparts of the kernels in `repro.quant.kernels`).

- `ecr_conv_int8_batch` replaces `ecr_conv_int8_pallas_batch` (and, at N=1
  with an identity-prefix schedule, `ecr_conv_int8_pallas`): the int8 entry
  point of `repro_torch/kernels/csrc/ecr_conv_int8.cu`.
- `bsr_matmul_int8` replaces `bsr_matmul_int8_pallas`: the int8 entry point
  of `repro_torch/kernels/csrc/bsr_matmul_int8.cu`.

Both take int8 operands, accumulate exactly in int32 and rescale at the
flush, in the reference's order: ((float)acc * sx[b]) * sw[o] for the conv,
((float)acc * sh[row]) * sw for the matmul. On a CUDA tensor they launch the
kernel and count the launch; on a CPU tensor they run the plain version.

The plain versions sum in float64, where integer sums of this size are
exact, then round to fp32 and rescale in the same order, so a kernel and its
plain version agree bitwise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bsr_matmul.kernel import scheduled_operand
from repro_torch.kernels.cuda import (
    check_bsr_operands,
    check_conv_operands,
    check_scales,
    count_launch,
    launch_bsr,
    launch_conv,
)
from repro_torch.kernels.ecr_conv.kernel import scheduled_conv_sum


def _flat(s: torch.Tensor) -> torch.Tensor:
    return s.reshape(-1).contiguous()


def ecr_conv_int8_plain(x, w, sx, sw, ids, cnt, *, stride: int = 1,
                        block_c: int) -> torch.Tensor:
    """x (N,H,W,C) int8, w (kh,kw,C,O) int8, sx (N values) and sw (O values)
    fp32 scales, ids (N,n_cb), cnt (N,) -> fp32 (N,OH,OW,O): the scheduled
    conv summed in float64, then ((float)acc * sx[b]) * sw[o]."""
    n, _, _, _, o = check_conv_operands(x, w, ids, cnt, block_c, stride)[:5]
    check_scales(sx, sw, n, o, "conv")
    acc = scheduled_conv_sum(x, w, ids, cnt, stride=stride, block_c=block_c,
                             dtype=torch.float64)
    return (acc.float() * _flat(sx).reshape(n, 1, 1, 1)) * _flat(sw)


def ecr_conv_int8_batch(x, w, sx, sw, ids, cnt, *, stride: int = 1,
                        block_c: int) -> torch.Tensor:
    """Batched int8 ECR conv with per-sample schedules and scales. CUDA
    tensor: the CUDA kernel; CPU tensor: the plain version."""
    if x.device.type == "cpu":
        return ecr_conv_int8_plain(x, w, sx, sw, ids, cnt, stride=stride,
                                   block_c=block_c)
    if x.device.type != "cuda":
        raise ValueError(f"ecr_conv_int8_batch runs on cuda or cpu, got {x.device}")
    out = launch_conv(x, w, ids, cnt, stride=stride, block_c=block_c,
                      sx=_flat(sx), sw=_flat(sw))
    count_launch(ecr_conv_int8_batch)
    return out


ecr_conv_int8_batch.launches = 0


def bsr_matmul_int8_plain(h, w, sh, sw, ids, cnt, *, block: tuple) -> torch.Tensor:
    """h (T,F) int8 @ w (F,D) int8 over the scheduled blocks of h, summed in
    float64, then ((float)acc * sh[row]) * sw -> fp32 (T,D)."""
    t, *_ = check_bsr_operands(h, w, ids, cnt, block)
    check_scales(sh, sw, t, 1, "BSR")
    acc = torch.matmul(scheduled_operand(h, ids, cnt, block).double(), w.double())
    return (acc.float() * _flat(sh).reshape(t, 1)) * _flat(sw)


def bsr_matmul_int8(h, w, sh, sw, ids, cnt, *, block: tuple) -> torch.Tensor:
    """int8 block-sparse matmul with per-row scales sh (T values) and one
    scale sw. CUDA tensor: the CUDA kernel; CPU tensor: the plain version."""
    if h.device.type == "cpu":
        return bsr_matmul_int8_plain(h, w, sh, sw, ids, cnt, block=block)
    if h.device.type != "cuda":
        raise ValueError(f"bsr_matmul_int8 runs on cuda or cpu, got {h.device}")
    out = launch_bsr(h, w, ids, cnt, block=block, sh=_flat(sh), sw=_flat(sw))
    count_launch(bsr_matmul_int8)
    return out


bsr_matmul_int8.launches = 0
