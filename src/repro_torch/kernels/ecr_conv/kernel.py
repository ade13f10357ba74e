"""ECR sparse conv kernel wrapper and its plain PyTorch version.

`ecr_conv_batch` replaces `repro.kernels.ecr_conv.kernel.ecr_conv_pallas_batch`
(and, at N=1 with an identity-prefix schedule, `ecr_conv_pallas`). On a CUDA
tensor it launches the hand-written kernel in
`repro_torch/kernels/csrc/ecr_conv.cu` and counts the launch in
`ecr_conv_batch.launches`; on a CPU tensor it runs `ecr_conv_plain`. There
is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cuda import check_block_o, check_conv_operands, count_launch, launch_conv


def scheduled_conv_sum(x: torch.Tensor, w: torch.Tensor, ids: torch.Tensor,
                       cnt: torch.Tensor, *, stride: int, block_c: int,
                       dtype: torch.dtype) -> torch.Tensor:
    """The scheduled conv sums in plain PyTorch, accumulated in `dtype`:
    x (N,H,W,C), w (kh,kw,C,O), ids (N,n_cb), cnt (N,) -> (N,OH,OW,O).

    Sample b gathers its scheduled channel blocks ids[b, :cnt[b]] (a live
    block left out of the schedule contributes nothing, exactly as in the
    kernel) and sums the per-tap (OH*OW, K) x (K, O) contractions."""
    n, h, wd, c, o, kh, kw, oh, ow = check_conv_operands(x, w, ids, cnt,
                                                          block_c, stride)
    n_cb = c // block_c
    xb = x.reshape(n, h, wd, n_cb, block_c)
    wb = w.reshape(kh, kw, n_cb, block_c, o)
    counts = cnt.clamp(0, n_cb).tolist()
    outs = []
    for b in range(n):
        sel = ids[b, :counts[b]].long()
        xs = xb[b][:, :, sel].reshape(h, wd, -1).to(dtype)  # (H, W, K)
        ws = wb[:, :, sel].reshape(kh, kw, -1, o).to(dtype)  # (kh, kw, K, O)
        acc = torch.zeros((oh * ow, o), dtype=dtype, device=x.device)
        for i in range(kh):
            for j in range(kw):
                patch = xs[i:i + (oh - 1) * stride + 1:stride,
                           j:j + (ow - 1) * stride + 1:stride]
                acc = acc + torch.matmul(patch.reshape(oh * ow, -1), ws[i, j])
        outs.append(acc.reshape(oh, ow, o))
    return torch.stack(outs)


def ecr_conv_plain(x: torch.Tensor, w: torch.Tensor, ids: torch.Tensor,
                   cnt: torch.Tensor, *, stride: int = 1, block_c: int,
                   pool: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch, schedule honored:
    `scheduled_conv_sum` in fp32, x (N,H,W,C), w (kh,kw,C,O), ids (N,n_cb),
    cnt (N,) -> (N,OH,OW,O). pool=p adds the PECR epilogue: ReLU, then
    p x p max-pool at stride p (floor)."""
    y = scheduled_conv_sum(x, w, ids, cnt, stride=stride, block_c=block_c,
                           dtype=x.dtype)
    if pool:
        n, oh, ow, o = y.shape
        poh, pw = oh // pool, ow // pool
        y = torch.relu(y)[:, :poh * pool, :pw * pool]
        y = y.reshape(n, poh, pool, pw, pool, o).amax(dim=(2, 4))
    return y


def ecr_conv_batch(x: torch.Tensor, w: torch.Tensor, ids: torch.Tensor,
                   cnt: torch.Tensor, *, stride: int = 1, block_c: int,
                   block_o: int = 0) -> torch.Tensor:
    """Batched ECR conv: x (N,H,W,C), w (kh,kw,C,O), per-sample schedules
    ids (N,n_cb) / cnt (N,) -> (N,OH,OW,O). CUDA tensor: the CUDA kernel,
    at the output-channel tile `block_o` (64 or 128; 0 = its own choice);
    CPU tensor: the plain version (the tile changes no value)."""
    check_block_o(block_o)
    if x.device.type == "cpu":
        return ecr_conv_plain(x, w, ids, cnt, stride=stride, block_c=block_c)
    if x.device.type != "cuda":
        raise ValueError(f"ecr_conv_batch runs on cuda or cpu, got {x.device}")
    out = launch_conv(x, w, ids, cnt, stride=stride, block_c=block_c, block_o=block_o)
    count_launch(ecr_conv_batch)
    return out


ecr_conv_batch.launches = 0
