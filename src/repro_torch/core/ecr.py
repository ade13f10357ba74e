"""Channel compaction and the dense conv oracle (counterpart of the parts of
`repro.core.ecr` the main path runs).

Convolution is invariant under a shared permutation of x's channels and the
kernels' input-channel dim, so a stable live-first argsort turns channel
sparsity into a contiguous prefix of live blocks that the `(ids, cnt)`
schedule then bounds — ECR's "pack nonzeros to the front" lifted to the
channel axis.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def compact_live_channels(x: torch.Tensor, kernels: torch.Tensor):
    """(C,H,W) x (O,C,kh,kw): pack live (any-nonzero) input channels into a
    dense prefix. Returns (x_packed, kernels_packed, n_live)."""
    live = (x != 0).flatten(1).any(dim=1)  # (C,)
    order = torch.argsort((~live).to(torch.int8), stable=True)
    n_live = live.sum(dtype=torch.int32)
    return x[order], kernels[:, order], n_live


def compact_live_channels_batch(x: torch.Tensor, kernels: torch.Tensor):
    """Batched compaction with ONE shared permutation over the union of live
    channels across the batch (the kernel tensor stays shared; per-sample
    raggedness comes back through per-sample block schedules). Returns
    (x_packed (N,C,H,W), kernels_packed, n_live_union)."""
    live = (x != 0).transpose(0, 1).flatten(1).any(dim=1)  # (C,)
    order = torch.argsort((~live).to(torch.int8), stable=True)
    n_live = live.sum(dtype=torch.int32)
    return x[:, order], kernels[:, order], n_live


def conv2d_dense(x: torch.Tensor, kernels: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Dense VALID conv (the cuDNN baseline): (C,H,W) -> (O,oh,ow) or
    (N,C,H,W) -> (N,O,oh,ow). On the card it runs in full fp32: the
    entry points turn TF32 off (`repro_torch.device.resolve_device`)."""
    if kernels.ndim == 3:
        kernels = kernels[None]
    batched = x.ndim == 4
    out = F.conv2d((x if batched else x[None]).float(), kernels.float(),
                   stride=stride)
    return out if batched else out[0]
