"""PECR (Pooling-pack ECR): fused convolution + ReLU + max-pool, paper §V
(counterpart of `repro.core.pecr`).

Algorithm 3 packs, per pooling window, the p*p convolution windows that feed
one pooled output (Data / Index / Count); Algorithm 4 runs the SpMV of each
packed conv window, applies ReLU and max-reduces, so the conv result never
leaves the SM. `pecr_compress` builds (n_pool_windows, p*p, C*kh*kw) packed
tensors and `pecr_conv_pool` consumes them. Like `core.ecr`, these are plain
PyTorch oracles; the fused CUDA kernel is ("conv_pool", "pecr_pallas") in
`repro_torch.kernels.conv_pool`. `fused_traffic_bytes` is the byte model of
the fusion (paper Fig. 3 / Fig. 12).

Paper Algorithm 3 line 11 stores ``Index[cnt] <- i*j+i``; the worked figures
need the row-major tap index ``i*k_w+j``, which is what is stored here, as
in the reference. `index` is the full live-first tap order: it is not
zeroed past Count (only `data` is).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.core.ecr import conv2d_dense, live_first, out_chunk
from repro_torch.core.sparsity import extract_windows


@dataclass
class PECR:
    data: torch.Tensor  # (n_pool, p*p, K) nonzero activations, packed front
    index: torch.Tensor  # (n_pool, p*p, K) int32 kernel-tap index of each value
    count: torch.Tensor  # (n_pool, p*p) int32 nonzeros per conv window
    out_shape: tuple  # (n_poh, n_pow)


def pecr_compress(x: torch.Tensor, kh: int, kw: int, c_s: int = 1, p: int = 2,
                  p_s: int | None = None) -> PECR:
    """Algorithm 3, vectorized: one row of `data` per pooling unit.

    x: (C,H,W) one image, or (N,C,H,W) a batch, which gives a PECR whose
    data / index / count carry a leading batch dim (shared out_shape)."""
    if x.ndim == 2:
        x = x[None]
    if x.ndim == 4:
        parts = [pecr_compress(xi, kh, kw, c_s, p, p_s) for xi in x]
        return PECR(data=torch.stack([q.data for q in parts]),
                    index=torch.stack([q.index for q in parts]),
                    count=torch.stack([q.count for q in parts]),
                    out_shape=parts[0].out_shape)
    p_s = p if p_s is None else p_s  # pooling stride (the paper uses p or 1)
    wins = extract_windows(x, kh, kw, c_s)  # (oh, ow, K) conv windows
    oh, ow, k = wins.shape
    n_poh = (oh - p) // p_s + 1
    n_pow = (ow - p) // p_s + 1
    dev = x.device
    iy = (torch.arange(n_poh, device=dev) * p_s)[:, None] + torch.arange(p, device=dev)
    ix = (torch.arange(n_pow, device=dev) * p_s)[:, None] + torch.arange(p, device=dev)
    # (n_poh, n_pow, p, p, K): conv window (iy[i, dh], ix[j, dw]) of unit (i, j)
    packed = wins[iy[:, None, :, None], ix[None, :, None, :]]
    packed = packed.reshape(-1, p * p, k)
    order, count, live = live_first(packed)
    data = torch.where(live, packed.gather(-1, order), 0)
    return PECR(data=data, index=order.to(torch.int32), count=count,
                out_shape=(n_poh, n_pow))


def pecr_conv_pool(pecr: PECR, kernel: torch.Tensor) -> torch.Tensor:
    """Algorithm 4: per pooling unit, p*p SpMVs -> ReLU -> max.

    Single-image PECR gives (n_poh, n_pow), batched (N, n_poh, n_pow).
    `kernel` is one output channel's (C,kh,kw), or (O',C,kh,kw) for O'
    channels at once (a leading O' dim on the result)."""
    kvec = kernel.reshape(kernel.shape[:-3] + (-1,)) if kernel.ndim == 4 \
        else kernel.reshape(-1)
    taps = kvec[..., pecr.index.long()]  # (..., n_pool, p*p, K)
    lane = torch.arange(pecr.data.shape[-1], device=pecr.data.device)
    live = lane < pecr.count.unsqueeze(-1)
    conv = torch.where(live, pecr.data * taps, 0.0).sum(-1)  # (..., n_pool, p*p)
    pooled = torch.relu(conv).amax(-1)  # ReLU (paper §V-D), then the max
    return pooled.reshape(pooled.shape[:-1] + tuple(pecr.out_shape))


def conv_pool_pecr(x: torch.Tensor, kernels: torch.Tensor, c_s: int = 1,
                   p: int = 2, p_s: int | None = None) -> torch.Tensor:
    """(C,H,W) x (O,C,kh,kw) -> (O, n_poh, n_pow) fused conv+ReLU+maxpool;
    batched (N,C,H,W) -> (N, O, n_poh, n_pow). Compression is per sample
    and done once; the taps are gathered for a chunk of output channels at
    a time (`core.ecr.ORACLE_WORKSPACE_BYTES`), where the reference maps
    over all of them at once: the same function."""
    if kernels.ndim == 3:
        kernels = kernels[None]
    o, c, kh, kw = kernels.shape
    pecr = pecr_compress(x, kh, kw, c_s, p, p_s)
    step = out_chunk(pecr.index.numel())
    out = torch.cat([pecr_conv_pool(pecr, kernels[o0:o0 + step])
                     for o0 in range(0, o, step)])  # (O, ...)
    return out.movedim(0, 1) if x.ndim == 4 else out


def conv_pool_unfused(x: torch.Tensor, kernels: torch.Tensor, c_s: int = 1,
                      p: int = 2, p_s: int | None = None) -> torch.Tensor:
    """Baseline: dense conv -> materialize -> ReLU -> VALID p x p max-pool at
    stride p_s (separate ops)."""
    p_s = p if p_s is None else p_s
    conv = torch.relu(conv2d_dense(x, kernels, c_s))
    return F.max_pool2d(conv, p, p_s)


def conv_pool(x, kernels, c_s: int = 1, p: int = 2, p_s: int | None = None,
              impl: str = "unfused") -> torch.Tensor:
    """Multi-impl conv+ReLU+pool entry point; the dispatch is the op
    registry's (`repro_torch.graph.registry`)."""
    from repro_torch.graph.ir import PoolSpec
    from repro_torch.graph.registry import get_op

    pool = PoolSpec(p, stride=0 if p_s is None else p_s, mode="floor")
    return get_op("conv_pool", impl).forward(x, kernels, stride=c_s, pool=pool)


def fused_traffic_bytes(x_shape, o, kh, kw, c_s=1, p=2, dtype_bytes=4) -> dict:
    """Modeled HBM traffic of fused vs unfused conv+pool for one layer."""
    c, h, w = x_shape
    oh, ow = (h - kh) // c_s + 1, (w - kw) // c_s + 1
    poh, pow_ = oh // p, ow // p
    read_x = c * h * w * dtype_bytes
    read_k = o * c * kh * kw * dtype_bytes
    conv_out = o * oh * ow * dtype_bytes
    pool_out = o * poh * pow_ * dtype_bytes
    unfused = read_x + read_k + conv_out + conv_out + pool_out  # write conv, re-read conv
    fused = read_x + read_k + pool_out
    return {"unfused_bytes": unfused, "fused_bytes": fused, "saved_frac": 1 - fused / unfused}
